"""The port's serving path held against the JAX package on the CPU.

* ``make_serve_step``, teacher-forced over 16 positions with the
  reference's params carried across, gives the reference's tokens in
  float32.  Where the reference's top two logits lie within 1e-4 of each
  other either token passes; ``NEAR_TIES`` counts how often that
  happened.  It also agrees with the port's own ``forward`` at more than
  0.95 (the reference's threshold in ``tests/test_decode.py``).
* ``make_prefill_step`` gives the reference's tokens and last hidden.
* ``PagedKVAllocator`` and ``ServeScheduler`` pass the cases of
  ``tests/test_decode.py``.
* ``repro_torch.launch.serve`` completes every request on the CPU for
  the gemma3, OLMo and olmoe smoke configs, with and without
  ``--transport``, and its loop gives the reference launcher loop's
  token stream for the same carried params and prompts (gemma3 and
  olmoe).

The moe smoke configs (olmoe-1b-7b, moonshot-v1-16b-a3b with its shared
expert) run the same decode and prefill checks in float32: a decode step
routes its b tokens with a capacity of 8 slots an expert, as the
reference's does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.completion import CompletionQueue as RCompletionQueue
from repro.distributed.comm import local_comm as r_local_comm
from repro.models.layers import lm_head_logits as r_lm_head_logits
from repro.models.registry import build_model as r_build_model
from repro.serving import PagedKVAllocator as RPagedKVAllocator
from repro.serving import ServeScheduler as RServeScheduler
from repro.serving.engine import init_cache as r_init_cache
from repro.serving.engine import make_prefill_step as r_make_prefill_step
from repro.serving.engine import make_serve_step as r_make_serve_step

from repro_torch.core.completion import CompletionQueue
from repro_torch.distributed import local_comm
from repro_torch.launch import serve as p_launch
from repro_torch.models.layers import greedy_sample, lm_head_logits
from repro_torch.models.registry import build_model
from repro_torch.serving import (PagedKVAllocator, ServeScheduler,
                                 init_cache, make_prefill_step,
                                 make_serve_step)
from test_torch_models import MODEL_CASES, carried_model

S, B = 16, 2
NEAR = 1e-4
#: (case, position, row) where the reference's top two logits were
#: within NEAR and the port took the other one
NEAR_TIES = []
SERVE_CASES = ["dense", "parallel", "swa-qk", "gemma3-1b-smoke",
               "olmoe-1b-7b-smoke", "moonshot-v1-16b-a3b-smoke",
               "minitron-8b-smoke", "command-r-plus-104b-smoke"]


def _tokens(cfg, s=S, b=B, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(s, b)
                                                ).astype(np.int32)


def _reference_logits(rcfg, params, tokens):
    """The reference forward's logits at every position, (s, b, V)."""
    comm = r_local_comm()
    x, _ = jax.jit(lambda p, t: r_build_model(rcfg).forward(
        p, {"tokens": t}, remat=False))(params, jnp.asarray(tokens))
    head = params.get("lm_head", params["emb"])
    return np.asarray(r_lm_head_logits(x, head, comm, real_vocab=rcfg.vocab))


def _same_or_near_tie(case, got, want, logits):
    """got == want wherever the reference's top two logits differ by more
    than NEAR; a near tie may go either way (recorded in NEAR_TIES)."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= NEAR
    ok = (got == want) | (near & np.isin(got, np.argsort(logits, -1)[..., -2:]
                                         ).reshape(got.shape))
    for i, j in zip(*np.nonzero(near & (got != want))):
        NEAR_TIES.append((case, int(i), int(j)))
    return ok


@pytest.mark.parametrize("case", SERVE_CASES)
def test_serve_step_matches_reference_and_forward(case):
    rcfg, params, pcfg, pparams = carried_model(MODEL_CASES[case], "float32")
    tokens = _tokens(rcfg)
    # reference decode, teacher-forced
    r_step = jax.jit(r_make_serve_step(rcfg))
    r_cache = r_init_cache(rcfg, S, B)
    want = []
    for i in range(S):
        nxt, r_cache = r_step(params, r_cache, jnp.asarray(tokens[i]))
        want.append(np.asarray(nxt))
    want = np.stack(want)
    # port decode, teacher-forced (cache written in place)
    step = make_serve_step(pcfg)
    cache = init_cache(pcfg, S, B, device="cpu")
    got = []
    for i in range(S):
        nxt, cache = step(pparams, cache, torch.from_numpy(tokens[i]))
        assert nxt.dtype == torch.int32 and cache.length == i + 1
        got.append(nxt.numpy())
    got = np.stack(got)
    logits = _reference_logits(rcfg, params, tokens)
    assert _same_or_near_tie(case, got, want, logits).all()
    # the port's decode agrees with its own forward
    x, _ = build_model(pcfg, device="cpu").forward(
        pparams, {"tokens": torch.from_numpy(tokens)})
    head = pparams.get("lm_head", pparams["emb"])
    oracle = greedy_sample(lm_head_logits(x, head, local_comm(),
                                          real_vocab=pcfg.vocab),
                           local_comm()).numpy()
    assert (got == oracle).mean() > 0.95


@pytest.mark.parametrize("case", ["dense", "gemma3-1b-smoke",
                                  "olmoe-1b-7b-smoke", "minitron-8b-smoke",
                                  "command-r-plus-104b-smoke"])
def test_prefill_step_matches_reference(case):
    rcfg, params, pcfg, pparams = carried_model(MODEL_CASES[case], "float32")
    tokens = _tokens(rcfg, s=12)
    want_tok, want_last = jax.jit(r_make_prefill_step(rcfg))(
        params, {"tokens": jnp.asarray(tokens)})
    got_tok, got_last = make_prefill_step(pcfg)(
        pparams, {"tokens": torch.from_numpy(tokens)})
    logits = _reference_logits(rcfg, params, tokens)[-1]
    assert _same_or_near_tie(case, got_tok.numpy()[None],
                             np.asarray(want_tok)[None],
                             logits[None]).all()
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               atol=1e-4, rtol=1e-4)


def test_unported_paths_raise():
    """Once "not ported" for the vlm and audio families: both now build on
    the CPU, and the port's serve launcher refuses them as the
    reference's does (its prompts carry no image or audio)."""
    from repro_torch.configs import get_smoke
    for arch in ("llama-3.2-vision-90b", "whisper-tiny"):   # vlm, audio
        model = build_model(get_smoke(arch), device="cpu")
        assert model.device.type == "cpu"
        with pytest.raises(SystemExit, match="decoder-only"):
            p_launch.main(["--arch", arch, "--smoke", "--device", "cpu"])
    # tp2d and joint_kv are ported: at one rank each decodes exactly the
    # plain step's tokens (their mesh runs: tests/test_torch_tp.py)
    _, _, pcfg, pparams = carried_model(MODEL_CASES["dense"], "float32")
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, pcfg.vocab, size=(6, 2)).astype(np.int32))
    runs = []
    for kw in ({}, {"tp2d": True}, {"joint_kv": True}):
        step = make_serve_step(pcfg, **kw)
        cache = init_cache(pcfg, 6, 2, device="cpu")
        preds = []
        for i in range(6):
            nxt, cache = step(pparams, cache, tok[i])
            preds.append(nxt)
        runs.append(torch.stack(preds))
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


# ---------------------------------------------------------------------------
# allocator and scheduler: the cases of tests/test_decode.py
# ---------------------------------------------------------------------------

class TestPagedAllocator:
    def test_admit_extend_release(self):
        alloc = PagedKVAllocator(n_pages=8, page_size=4)
        st = alloc.admit(1, prompt_len=10)        # needs 3 pages
        assert st.is_done() and alloc.free_pages == 5
        assert alloc.extend(1, 16).is_done()      # grow to 4 pages
        assert alloc.free_pages == 4
        alloc.release(1)
        assert alloc.free_pages == 8

    def test_all_or_nothing_admission(self):
        alloc = PagedKVAllocator(n_pages=2, page_size=4)
        assert alloc.admit(1, 8).is_done()
        st = alloc.admit(2, 8)                    # no pages left
        assert st.is_retry()
        assert alloc.free_pages == 0              # no partial reservation

    def test_page_table_lookup(self):
        alloc = PagedKVAllocator(n_pages=4, page_size=4)
        alloc.admit(7, 8)
        table = alloc.tables[7]
        page, off = table.slot_of(5)
        assert off == 1 and page == table.pages[1]


class TestScheduler:
    @staticmethod
    def _engine():
        def decode_fn(tokens, positions):         # next token = token + 1
            return tokens + 1
        return decode_fn

    @pytest.mark.parametrize("pkg", ["port", "reference"])
    def test_continuous_batching_completes(self, pkg):
        alloc_t, sched_t, cq_t = (
            (PagedKVAllocator, ServeScheduler, CompletionQueue) if pkg ==
            "port" else (RPagedKVAllocator, RServeScheduler,
                         RCompletionQueue))
        alloc = alloc_t(n_pages=64, page_size=4)
        sched = sched_t(self._engine(), max_batch=4, allocator=alloc)
        cq = cq_t()
        for i in range(10):
            st = sched.submit(np.array([i]), max_new=3, comp=cq,
                              allow_retry=False)
            assert not st.is_retry()
        rounds = 0
        while sched.completed < 10:
            sched.step()
            rounds += 1
            assert rounds < 100
        outs = []
        while True:
            st = cq.pop()
            if st.is_retry():
                break
            outs.append(st.get_buffer().tolist())
        assert sorted(outs) == [[i + 1, i + 2, i + 3] for i in range(10)]

    def test_backlog_under_page_pressure(self):
        alloc = PagedKVAllocator(n_pages=4, page_size=4)   # tiny
        sched = ServeScheduler(self._engine(), max_batch=8,
                               allocator=alloc)
        sts = [sched.submit(np.array([1, 2]), max_new=4, allow_retry=False)
               for _ in range(6)]
        assert any(s.code.name == "POSTED_BACKLOG" for s in sts)
        rounds = 0
        while sched.completed < 6:
            sched.step()
            rounds += 1
            assert rounds < 200
        assert sched.completed == 6
        assert alloc.free_pages == 4


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-1b", "olmo-1b", "olmoe-1b-7b"])
@pytest.mark.parametrize("transport", [False, True])
def test_launcher_completes_every_request(arch, transport, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "8",
            "--max-new", "6"] + (["--transport"] if transport else [])
    out = p_launch.main(argv)
    assert out["completed"] == 8 and out["tokens"] == 48
    assert all(r is not None and len(r) == 6 for r in out["results"])
    printed = capsys.readouterr().out
    assert "8 requests, 48 tokens" in printed
    assert ("prefill endpoint posts per device" in printed) == transport


def test_launcher_loop_matches_reference_launcher():
    """The reference launcher's loop (``repro/launch/serve.py``) and the
    port's :func:`serve`, on the same carried params and prompts, emit
    the same token stream per request: 6 requests, 4 slots, so the
    second wave decodes on the cache the first one left."""
    _launcher_loops_agree("gemma3-1b-smoke")


def test_launcher_loop_matches_reference_launcher_moe():
    """The same for olmoe's smoke config: each round routes the active
    slots through the experts (capacity 8 an expert)."""
    _launcher_loops_agree("olmoe-1b-7b-smoke")


def _launcher_loops_agree(case):
    """``case``: a name of MODEL_CASES or a reference config."""
    cfg = MODEL_CASES[case] if isinstance(case, str) else case
    rcfg, params, pcfg, pparams = carried_model(cfg, "float32")
    requests, max_new, max_batch, cache_len = 6, 5, 4, 32
    # the reference launcher's loop, as repro/launch/serve.py runs it
    serve = jax.jit(r_make_serve_step(rcfg))
    state = {"cache": r_init_cache(rcfg, cache_len, max_batch)}

    def decode_fn(tokens, positions):
        pad = max_batch - len(tokens)
        toks = jnp.asarray(np.pad(tokens, (0, pad)), jnp.int32)
        nxt, state["cache"] = serve(params, state["cache"], toks)
        return np.asarray(nxt)[:len(tokens)]

    sched = RServeScheduler(decode_fn, max_batch=max_batch,
                            allocator=RPagedKVAllocator(256, 16))
    cq = sched.alloc_cq()
    rng = np.random.default_rng(0)
    order = []
    for _ in range(requests):
        st = sched.submit(rng.integers(0, rcfg.vocab, size=8), max_new,
                          comp=cq, allow_retry=False)
        order.append(st.user_context)
    while sched.completed < requests:
        sched.step()
    by_rid = {}
    while True:
        st = cq.pop()
        if st.is_retry():
            break
        by_rid[st.tag] = np.asarray(st.get_buffer()).tolist()
    want = [by_rid[r] for r in order]

    got = p_launch.serve(pcfg, pparams, requests=requests, max_new=max_new,
                         max_batch=max_batch, cache_len=cache_len,
                         device="cpu")
    assert got["completed"] == requests and got["retries"] == 2
    assert [r.tolist() for r in got["results"]] == want
