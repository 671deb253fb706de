"""The port's CUDA kernels on the card, against their plain PyTorch
versions: the doorbell stage copy (B1), flash attention (B2, any head dim
up to 256), RMSNorm (B3), the MoE grouped matmul (B4) and the SSD scan
(B5), plus the model path's launch counts, and CUDA doorbells over the
``shm`` and ``socket`` transports (one gather, one copy to the host a
frame, one back to the card a frame of rows for CUDA recv buffers).

Every test here is marked ``gpu`` and skips without a CUDA card (the
decision is taken in a fixture, never at import).  The file imports no
JAX, so it runs on the card's machine, which has none:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

``chip_smoke.py`` holds the same kernels at the main paths' shapes and
drives the message path, gemma3-1b, olmoe-1b-7b, mamba2-370m and
hymba-1.5b serving at full width.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import FatalError, LocalCluster
from repro_torch.core.packet_pool import init_buffers, init_pool
from repro_torch.core.transport.codec import encode_msg
from repro_torch.core.transport.wire import to_card, to_host
from repro_torch.configs import get_smoke
from repro_torch.kernels import doorbell as db
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bhsd,
                                                 flash_attention_ref,
                                                 variant, variant_of)
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref
from repro_torch.kernels.moe_gmm.ref import activation_f32
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bhsp,
                                          ssd_scan_ref, ssd_scan_tc_ref)
from repro_torch.kernels.ssd_scan import variant as ssd_variant
from repro_torch.kernels.ssd_scan import variant_of as ssd_variant_of
from repro_torch.models.registry import build_model
from repro_torch.serving import init_cache, make_prefill_step, \
    make_serve_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py holds the kernel "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,dtype", [((64, 2), torch.float32),
                                         ((64, 16384), torch.float32),
                                         ((63, 8), torch.uint8),
                                         ((5, 7), torch.int32),
                                         ((3, 1027), torch.float32)])
@pytest.mark.parametrize("bf16", [False, True])
def test_stage_copy_matches_plain(cuda, shape, dtype, bf16):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=g) * 100).to(dtype).to(cuda)
    before = db.stage_copy.launches
    out = db.stage_copy(x, wire_bf16=bf16)
    assert db.stage_copy.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, db.stage_copy_ref(x, wire_bf16=bf16))


@pytest.mark.parametrize("bf16", [False, True])
def test_stage_copy_push_matches_plain(cuda, bf16):
    """A full grab and then a short one: only the ``got`` prefix moves."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(16, 100, generator=g).to(cuda)
    pool = init_pool(2, 16, device=cuda)
    buf = torch.randint(0, 256, (32, 512), generator=g,
                        dtype=torch.uint8).to(cuda)
    kp, kb, pp, pb = pool, buf.clone(), pool, buf.clone()
    for want_got in (16, 8):
        kp, kb, kids, kgot, _ = db.stage_copy_push(kp, kb, 0, x, -3,
                                                   wire_bf16=bf16)
        pp, pb, pids, pgot, _ = db.stage_copy_push_ref(pp, pb, 0, x, -3,
                                                       wire_bf16=bf16)
        torch.cuda.synchronize()
        assert int(kgot) == int(pgot) == want_got
        assert torch.equal(kids, pids) and torch.equal(kb, pb)
        assert torch.equal(kp.slots, pp.slots)


def _rows_case(cuda, kind, k, e, dtype, g):
    """K row tensors: in separate allocations, or views into one buffer
    at offsets that are not 16-byte aligned (odd byte offsets for
    uint8)."""
    def draw(n):
        if dtype == torch.uint8:
            return torch.randint(0, 256, (n,), generator=g, dtype=dtype)
        return (torch.randn(n, generator=g) * 100).to(dtype)
    if kind == "separate":
        return [draw(e).to(cuda) for _ in range(k)]
    buf = draw(k * (e + 1) + 1).to(cuda)
    return [buf[1 + i * (e + 1):1 + i * (e + 1) + e] for i in range(k)]


def _equal_wire(out, ref, nan_ok=False):
    """Equal bytes; with ``nan_ok`` bf16 NaNs compared by isnan (the
    kernel's cvt.rn and torch's cast give different NaN patterns)."""
    if not nan_ok:
        return torch.equal(out, ref)
    a, b = out.view(torch.int16), ref.view(torch.int16)
    an = torch.isnan(out.view(torch.bfloat16))
    bn = torch.isnan(ref.view(torch.bfloat16))
    return torch.equal(an, bn) and torch.equal(a[~an], b[~bn])


@pytest.mark.parametrize("kind,k,e,dtype", [
    ("separate", 64, 16384, torch.float32),
    ("separate", 64, 2048, torch.float32),
    ("separate", 5, 1027, torch.float32),       # rows with a tail
    ("separate", 64, 8, torch.uint8),           # 8-byte rows
    ("separate", 63, 2, torch.int32),
    ("offset", 64, 8, torch.uint8),             # odd byte offsets
    ("offset", 7, 4099, torch.uint8),
    ("offset", 9, 1027, torch.float32),         # 4-byte, not 16-byte, aligned
    ("offset", 16, 2048, torch.float32),
])
@pytest.mark.parametrize("bf16", [False, True])
def test_stage_copy_rows_matches_plain(cuda, kind, k, e, dtype, bf16):
    g = torch.Generator().manual_seed(5)
    rows = _rows_case(cuda, kind, k, e, dtype, g)
    before = db.stage_copy_rows.launches
    out = db.stage_copy_rows(rows, wire_bf16=bf16)
    assert db.stage_copy_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, db.stage_copy_rows_ref(rows, wire_bf16=bf16))


@pytest.mark.parametrize("bf16", [False, True])
def test_stage_copy_rows_takes_two_launches_past_256_rows(cuda, bf16):
    g = torch.Generator().manual_seed(6)
    rows = _rows_case(cuda, "separate", 257, 300, torch.float32, g)
    before = db.stage_copy_rows.launches
    out = db.stage_copy_rows(rows, wire_bf16=bf16)
    assert db.stage_copy_rows.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(out, db.stage_copy_rows_ref(rows, wire_bf16=bf16))


def test_stage_copy_rows_nan_and_special_values(cuda):
    g = np.random.default_rng(7)
    vals = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 1e-40, 1e-45,
                     3.4028235e38, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8],
                    np.float32)
    rows = [torch.from_numpy(g.choice(vals, 2048).astype(np.float32)).to(cuda)
            for _ in range(64)]
    for bf16 in (False, True):
        out = db.stage_copy_rows(rows, wire_bf16=bf16)
        torch.cuda.synchronize()
        assert _equal_wire(out, db.stage_copy_rows_ref(rows, wire_bf16=bf16),
                           nan_ok=bf16)


def test_stage_copy_rows_takes_strided_rows(cuda):
    """A non-contiguous row is made contiguous first, as torch.stack
    takes it."""
    src = torch.randn(16, 64, device=cuda)
    rows = list(src.t())
    out = db.stage_copy_rows(rows)
    torch.cuda.synchronize()
    assert torch.equal(out, db.stage_copy_rows_ref(rows))


def test_main_path_launches_once_per_doorbell(cuda):
    """A fused doorbell of CUDA rows is one gather launch, and no dense
    stage copy (the rows are not stacked first)."""
    cl = LocalCluster(2, device=cuda, attrs={"wire_bf16": True})
    ep0, ep1 = cl.alloc_endpoint(n_devices=2)
    cq = cl[1].alloc_cq()
    rc = cl[1].register_rcomp(cq)
    src = torch.randn(8, 64, device=cuda)
    before, dense = db.stage_copy_rows.launches, db.stage_copy.launches
    sts = ep0.post_am_many(1, list(src), rc, tags=list(range(8)))
    assert all(s.is_done() for s in sts)
    assert db.stage_copy_rows.launches == before + 1
    assert db.stage_copy.launches == dense
    cl.quiesce()
    got = {}
    while True:
        s = cq.pop()
        if not s.is_done():
            break
        got[s.tag] = s.get_buffer()
    assert sorted(got) == list(range(8))
    want = src.to(torch.bfloat16).float().view(torch.uint8)
    assert torch.equal(torch.stack([got[t] for t in range(8)]), want)


def test_repeated_payload_stages_one_gathered_row(cuda):
    """One CUDA tensor posted K times: one gather launch of one row,
    broadcast K ways, and no dense stage copy."""
    from repro_torch.core.progress.fabric import pack_payloads
    x = torch.randn(33, device=cuda)
    before, dense = db.stage_copy_rows.launches, db.stage_copy.launches
    got, sizes, dt = pack_payloads([x] * 5, wire_bf16=True,
                                   device=x.device)
    assert db.stage_copy_rows.launches == before + 1
    assert db.stage_copy.launches == dense
    torch.cuda.synchronize()
    assert dt == "bf16" and list(sizes) == [x.nbytes] * 5
    want = db.stage_copy_ref(x.reshape(1, -1), wire_bf16=True)
    assert torch.equal(got, want.expand(5, -1))


def test_cuda_payload_on_cpu_runtime_raises(cuda):
    cl = LocalCluster(2, device="cpu")
    ep0, _ = cl.alloc_endpoint()
    rc = cl[1].register_rcomp(cl[1].alloc_cq())
    with pytest.raises(FatalError):
        ep0.post_am_many(1, [torch.zeros(4, device=cuda)] * 4, rc)


def test_recv_into_host_buffer_copies_explicitly(cuda):
    cl = LocalCluster(2, device=cuda)
    ep0, ep1 = cl.alloc_endpoint()
    host = np.zeros(16, np.uint8)
    ep1.post_recv(0, host, 16, tag=5)
    ep0.post_send_many(1, [torch.full((16,), 9, dtype=torch.uint8,
                                      device=cuda)] * 4, tags=[5, 6, 7, 8])
    cl.quiesce()
    assert (host == 9).all()


def _transport_run(cuda, backend, kind, bf16, attrs=None, doorbells=2):
    """``doorbells`` fused doorbells of 64 rows of 64 KiB float32 on the
    card over ``backend`` (many large rows: a copy to the host that did
    not wait for the gather would ship stale bytes); returns the gather
    launches, the CUDA frames encoded, the copies each way, the
    receiver's bytes and the sent ones, and the sender's reliability
    counters."""
    cl = LocalCluster(2, device=cuda, attrs={
        "fabric_backend": backend, "wire_bf16": bf16, **(attrs or {})})
    try:
        ep0, ep1 = cl.alloc_endpoint(n_devices=1)
        cq = cl[1].alloc_cq()
        rc = cl[1].register_rcomp(cq)
        g = torch.Generator(device=cuda).manual_seed(3)
        src = torch.randn(64 * doorbells, 16384, generator=g, device=cuda)
        rbuf = torch.zeros_like(src)
        tags = list(range(64 * doorbells))
        if kind == "send":
            for t in tags:
                ep1.post_recv(0, rbuf[t], 65536, tag=t, local_comp=cq)
        before = (db.stage_copy_rows.launches, encode_msg.cuda_frames,
                  to_host.copies, to_card.copies)
        for d in range(doorbells):
            sl = slice(64 * d, 64 * d + 64)
            post = (ep0.post_send_many(1, list(src[sl]), tags=tags[sl])
                    if kind == "send" else
                    ep0.post_am_many(1, list(src[sl]), rc, tags=tags[sl]))
            assert not any(st.is_retry() for st in post)
        cl.quiesce()
        got = {}
        while True:
            st = cq.pop()
            if not st.is_done():
                break
            assert st.tag not in got
            got[st.tag] = st.get_buffer()
        assert sorted(got) == tags
        if kind == "send":
            have = rbuf.view(torch.uint8)
        else:
            assert all(isinstance(b, np.ndarray) for b in got.values())
            have = torch.stack([torch.from_numpy(got[t]) for t in tags]
                               ).to(cuda)
        want = src
        if bf16:
            want = src.to(torch.bfloat16).float()
        counts = tuple(a - b for a, b in zip(
            (db.stage_copy_rows.launches, encode_msg.cuda_frames,
             to_host.copies, to_card.copies),
            before))
        rel = cl[0].rel.counters() if cl[0].rel is not None else None
        return counts, have, want.view(torch.uint8), rel
    finally:
        cl.close()


@pytest.mark.parametrize("kind,bf16", [("am", False), ("am", True),
                                       ("send", False)])
@pytest.mark.parametrize("backend", ["shm", "socket"])
def test_transport_carries_cuda_doorbells(cuda, backend, kind, bf16):
    """Each fused doorbell of CUDA rows: one gather launch, one copy of
    the frame to the host, and for sends into CUDA recv buffers one copy
    of the frame's rows back to the card; an AM lands as host bytes.
    Every row byte-exact."""
    (launches, frames, to_h, to_c), have, want, _ = _transport_run(
        cuda, backend, kind, bf16)
    assert (launches, frames, to_h, to_c) == \
        (2, 2, 2, 2 if kind == "send" else 0)
    assert torch.equal(have, want)


def test_transport_retransmit_copies_again(cuda):
    """Under chaos a retransmit re-encodes its frame: the CUDA image
    crosses to the host once more for each retransmit, and every row is
    still delivered once, byte-exact."""
    (launches, frames, to_h, to_c), have, want, rel = _transport_run(
        cuda, "shm", "send", False, doorbells=8,
        attrs={"reliability": "on", "chaos_seed": 7, "chaos_drop": 0.2,
               "chaos_dup": 0.05, "chaos_reorder": 0.05})
    assert launches == 8
    assert to_h == frames == 8 + rel["retransmits"]
    assert rel["retransmits"] > 0
    assert 8 <= to_c <= to_h
    assert torch.equal(have, want)


# ---------------------------------------------------------------------------
# B2 flash attention and B3 RMSNorm
# ---------------------------------------------------------------------------

def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 5e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window,q_offset", [
    (2, 4, 2, 64, 64, 16, True, 0, 0),
    (1, 4, 1, 128, 128, 32, True, 32, 0),
    (2, 2, 2, 64, 128, 16, True, 0, 64),
    (1, 6, 3, 96, 96, 16, False, 0, 0),
    (1, 8, 8, 32, 32, 64, True, 8, 0),
    (1, 4, 4, 100, 100, 128, True, 0, 0),     # ragged, OLMo's dh
    (2, 4, 1, 70, 70, 256, True, 1 << 30, 0),  # gemma3's dh, global
    (1, 2, 1, 40, 24, 256, True, 8, 20),      # rows that see no key
    (2, 4, 2, 48, 48, 12, True, 0, 0),        # minitron smoke's dh, padded
    (2, 4, 4, 33, 33, 24, True, 0, 0),        # the moe smoke configs' dh
    (1, 4, 2, 64, 64, 96, True, 16, 0),       # dh 96, padded to 128
])
def test_flash_attention_matches_plain(cuda, b, hq, hkv, sq, skv, dh,
                                       causal, window, q_offset, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(cuda)
               for shape in ((b, hq, sq, dh), (b, hkv, skv, dh),
                             (b, hkv, skv, dh)))
    before = flash_attention_bhsd.launches
    out, kind = variant_of(lambda: flash_attention_bhsd(
        q, k, v, causal=causal, window=window, q_offset=q_offset))
    assert flash_attention_bhsd.launches == before + 1
    assert kind == variant(q, k, v)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


#: the tensor-core variant against the plain version of its own arithmetic
#: (P in bf16): what rounding the output to bf16 and a different order of
#: the float32 sums leave
TC_ATOL, TC_RTOL = 4e-3, 8e-3


def _check_tc(cuda, b, hq, hkv, sq, skv, dh, causal, window, q_offset,
              seed=4):
    """bf16 through the wrapper: the call takes the tensor-core variant
    and lands within TC_ATOL + TC_RTOL |ref| of the plain version with P
    rounded to bf16 (what the variant computes), and within bf16's 2e-2
    of the one with P in float32 (the reference's arithmetic)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16).to(cuda)
               for shape in ((b, hq, sq, dh), (b, hkv, skv, dh),
                             (b, hkv, skv, dh)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, kind = variant_of(lambda: flash_attention_bhsd(q, k, v, **kw))
    torch.cuda.synchronize()
    assert kind == "tc" and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    for p_dtype, atol, rtol in ((torch.bfloat16, TC_ATOL, TC_RTOL),
                                (None, 2e-2, 2e-2)):
        ref = flash_attention_ref(q, k, v, p_dtype=p_dtype, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
    return q, k, v, out


@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 129, 1000])
def test_flash_tc_matches_plain(cuda, dh, s):
    """Causal self-attention at GQA 4 across the tiles' edges (128 q
    rows a block, 128 keys a tile at dh 64/128 and 64 at dh 256)."""
    _check_tc(cuda, 2, 8, 2, s, s, dh, True, 0, 0)


#: (name, b, hq, hkv, sq, skv, causal, window, q_offset); BK is the key
#: tile (128 at dh 64 and 128, 64 at dh 256)
TC_MASKS = [
    ("q_offset", 1, 4, 1, 65, 1000, True, 0, 935),
    ("q_offset_short_kv", 1, 4, 4, 129, 63, True, 0, 40),
    ("bidirectional", 1, 5, 1, 127, 129, False, 0, 0),
    ("window_1", 1, 4, 1, 300, 300, True, 1, 0),
    ("window_bk_minus_1", 1, 4, 1, 300, 300, True, "bk-1", 0),
    ("window_bk", 1, 4, 1, 300, 300, True, "bk", 0),
    ("window_bk_plus_1", 1, 4, 1, 300, 300, True, "bk+1", 0),
    ("no_key_rows", 1, 4, 1, 256, 128, True, 64, 100),
    ("no_key_rows_all", 1, 2, 1, 64, 32, True, 8, 200),
    ("gqa_1", 2, 4, 4, 200, 200, True, 0, 0),
    ("gqa_4", 2, 16, 4, 200, 200, True, 50, 0),
    ("gqa_5", 2, 25, 5, 200, 200, True, 100, 0),
]


@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("case", TC_MASKS, ids=[c[0] for c in TC_MASKS])
def test_flash_tc_masks(cuda, dh, case):
    _, b, hq, hkv, sq, skv, causal, window, q_offset = case
    bk = 64 if dh == 256 else 128
    if isinstance(window, str):
        window = bk + {"bk-1": -1, "bk": 0, "bk+1": 1}[window]
    _check_tc(cuda, b, hq, hkv, sq, skv, dh, causal, window, q_offset)


def test_flash_tc_no_key_rows_average_uniformly(cuda):
    """Rows past the keys' window come out as the mean of all of v."""
    q, k, v, out = _check_tc(cuda, 1, 4, 1, 256, 128, 256, True, 64, 100)
    uniform = v.float()[0, 0].mean(dim=0)
    # positions >= 191 (rows 91..) see no key
    torch.testing.assert_close(out.float()[0, :, 91:],
                               uniform.expand(4, 256 - 91, 256), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_tc_reads_strided_views_bitwise(cuda, dh):
    """The seq-major wrapper reads q, k, v and writes o in place through
    their strides; a head slice of a wider tensor is read in place too,
    and a view off a 16-byte boundary is copied and stays on "tc".  All
    give bitwise the output of contiguous (b, h, s, dh) input."""
    g = torch.Generator().manual_seed(5)
    s, b, hq, hkv = 300, 2, 8, 2
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16).to(cuda)
               for shape in ((s, b, hq, dh), (s, b, hkv, dh),
                             (s, b, hkv, dh)))
    kw = dict(causal=True, window=100, q_offset=0)
    dense = [t.permute(1, 2, 0, 3).contiguous() for t in (q, k, v)]
    want = flash_attention_bhsd(*dense, **kw)
    got, kind = variant_of(lambda: flash_attention(q, k, v, **kw))
    torch.cuda.synchronize()
    assert kind == "tc" and got.is_contiguous()
    assert torch.equal(got.permute(1, 2, 0, 3), want)
    wide = torch.randn((b, 2 * hq, s, dh), generator=g).to(
        torch.bfloat16).to(cuda)
    wide[:, 1::2] = dense[0]
    sliced, kind = variant_of(lambda: flash_attention_bhsd(
        wide[:, 1::2], dense[1], dense[2], **kw))
    assert kind == "tc"
    assert torch.equal(sliced, want)
    flat = torch.empty(dense[0].numel() + 1, dtype=torch.bfloat16,
                       device=cuda)
    odd = flat[1:].view(dense[0].shape)              # 2 bytes off
    odd.copy_(dense[0])
    assert odd.data_ptr() % 16
    moved, kind = variant_of(lambda: flash_attention_bhsd(
        odd, dense[1], dense[2], **kw))
    assert kind == "tc"
    assert torch.equal(moved, want)


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 64),
                                      (torch.float32, 256),
                                      (torch.bfloat16, 16),
                                      (torch.bfloat16, 24)])
def test_flash_simt_takes_float32_and_small_head_dims(cuda, dtype, dh):
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(cuda)
               for shape in ((1, 4, 70, dh), (1, 2, 70, dh), (1, 2, 70, dh)))
    out, kind = variant_of(lambda: flash_attention_bhsd(q, k, v))
    torch.cuda.synchronize()
    assert kind == "simt" == variant(q, k, v)
    torch.testing.assert_close(out.float(), flash_attention_ref(
        q, k, v).float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(8, 64), (64, 128), (100, 96), (1, 256),
                                    (100, 1152), (7, 100)])
@pytest.mark.parametrize("w_dtype", [None, torch.float32, torch.bfloat16])
def test_rmsnorm_matches_plain(cuda, rows, d, dtype, w_dtype):
    _check_rmsnorm(cuda, rows, d, dtype, w_dtype, seed=3)


def _check_rmsnorm(cuda, rows, d, dtype, w_dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, d, generator=g) * 3).to(dtype).to(cuda)
    w = None if w_dtype is None else \
        torch.randn(d, generator=g).to(w_dtype).to(cuda)
    before = rmsnorm.launches
    out = rmsnorm(x, w)
    assert rmsnorm.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, w).float(),
                               atol=_tol(dtype), rtol=_tol(dtype))


#: the widths the row kernel is instantiated for (csrc/rmsnorm.cu: the
#: served paths' norms), each range's edges, and a width the generic
#: kernel takes (1027: rows not 16-byte aligned)
RMS_WIDTHS = [128, 256, 1024, 1152, 1600, 2048, 3200, 1027, 264, 3328, 3336]


@pytest.mark.parametrize("d", RMS_WIDTHS)
@pytest.mark.parametrize("rows", [1, 7, 8192])
@pytest.mark.parametrize("w_dtype", [None, torch.float32, torch.bfloat16])
def test_rmsnorm_row_kernel_widths(cuda, d, rows, w_dtype):
    for dtype in (torch.bfloat16, torch.float32):
        _check_rmsnorm(cuda, rows, d, dtype, w_dtype, seed=d + rows)


def test_rmsnorm_counts_launches_by_shape(cuda):
    x = torch.randn(24, 256, device=cuda, dtype=torch.bfloat16)
    before = dict(rmsnorm.launches_by_shape)
    rmsnorm(x, None)
    rmsnorm(x.reshape(2, 12, 256), None)
    assert rmsnorm.launches_by_shape[24, 256] == before.get((24, 256), 0) + 2


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    x = torch.randn(8, 64, device=cuda)
    with pytest.raises(ValueError):
        rmsnorm(x.t(), None)                         # not contiguous
    with pytest.raises(ValueError):
        rmsnorm(x.half(), None)
    q = torch.randn(1, 2, 8, 300, device=cuda)        # dh > 256
    with pytest.raises(ValueError):
        flash_attention_bhsd(q, q[:, :1], q[:, :1])


#: RMSNorm launches a layer, by smoke config: norm1, q_norm, k_norm, norm2
#: on the qk-norm models; norm1 and norm2 on moonshot; none for command-r's
#: LayerNorm; norm1 and the gated norm on mamba2; norm1, the gated norm,
#: the two mix norms and norm2 on hymba
RMS_PER_LAYER = {"gemma3-1b": 4, "command-r-plus-104b": 0, "olmoe-1b-7b": 4,
                 "moonshot-v1-16b-a3b": 2, "mamba2-370m": 2,
                 "hymba-1.5b": 5}


@pytest.mark.parametrize("arch", list(RMS_PER_LAYER))
def test_model_path_launches_the_kernels(cuda, arch):
    """Prefill: one flash-attention launch an attention layer and one
    SSD-scan launch an ssm or hybrid layer; RMSNorm launches on every
    rmsnorm of the model plus the final norm (none for command-r's
    LayerNorm); one MoE grouped-matmul launch a moe layer, in prefill and
    in every decode step.  Decode never launches flash attention or the
    SSD scan.  (The moe smoke configs have head dim 24, which the
    flash-attention wrapper pads to 32.)"""
    cfg = get_smoke(arch)
    params, _ = build_model(cfg, device=cuda).init(0)
    tokens = torch.randint(0, cfg.vocab, (16, 2), device=cuda)
    per_step = RMS_PER_LAYER[arch] * cfg.n_layers + 1 \
        if RMS_PER_LAYER[arch] else 0
    moe_per_step = cfg.n_layers if cfg.family == "moe" else 0
    n_attn = 0 if cfg.family == "ssm" else cfg.n_layers
    n_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    f0, r0, m0, s0 = flash_attention_bhsd.launches, rmsnorm.launches, \
        moe_gmm.launches, ssd_scan_bhsp.launches
    tok, _ = make_prefill_step(cfg)(params, {"tokens": tokens})
    assert flash_attention_bhsd.launches - f0 == n_attn
    assert rmsnorm.launches - r0 == per_step
    assert moe_gmm.launches - m0 == moe_per_step
    assert ssd_scan_bhsp.launches - s0 == n_ssd
    step = make_serve_step(cfg)
    cache = init_cache(cfg, 16, 2, device=cuda)
    f0, r0, m0 = flash_attention_bhsd.launches, rmsnorm.launches, \
        moe_gmm.launches
    s0 = ssd_scan_bhsp.launches
    for i in range(4):
        tok, cache = step(params, cache, tokens[i])
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches == f0
    assert ssd_scan_bhsp.launches == s0
    assert rmsnorm.launches - r0 == 4 * per_step
    assert moe_gmm.launches - m0 == 4 * moe_per_step
    assert tok.shape == (2,) and cache.length == 4


# ---------------------------------------------------------------------------
# B4 the MoE grouped matmul
# ---------------------------------------------------------------------------

def _gmm_inputs(e, cap, d, f, act, dtype, cuda, seed=4, w_scale=0.2):
    """x ~ N(0, 1); weights N(0, 1) times ``w_scale`` (tests/test_kernels.py's
    0.2, or None for 1/sqrt(fan in), olmoe's scale)."""
    mult = 2 if act in ("swiglu", "geglu") else 1
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(e, cap, d, generator=g)
    w1 = torch.randn(e, d, mult * f, generator=g) * (w_scale or d ** -0.5)
    w2 = torch.randn(e, f, d, generator=g) * (w_scale or f ** -0.5)
    return (t.to(dtype).to(cuda) for t in (x, w1, w2))


def _want_variant(d, dtype):
    """bf16 with d (and f) a multiple of 8 takes the tensor cores."""
    return "tc" if dtype == torch.bfloat16 and d % 8 == 0 else "simt"


def _plain_of(kind, x, w1, w2, act, rows=None):
    """The plain version of what each variant computes: the CUDA-core
    variant keeps h in float32 (``moe_gmm_ref``); the tensor-core variant
    rounds h to bfloat16 between the products (its operand type, the JAX
    model's rounding).  At these inputs' scale (h ~ 10 at d = 256) that
    rounding alone moves outputs near 0 by up to ~0.06, past 3e-2 of the
    float32-h version; at olmoe's weight scale (chip_smoke.py) the
    tensor-core variant stays within 3e-2 of ``moe_gmm_ref`` itself."""
    if kind == "simt":
        return moe_gmm_ref(x, w1, w2, act=act, rows=rows)
    h = activation_f32(act, torch.einsum("ecd,edf->ecf", x.float(),
                                         w1.float()))
    o = torch.einsum("ecf,efd->ecd", h.to(torch.bfloat16).float(),
                     w2.float())
    if rows is not None:
        keep = torch.arange(o.shape[1], device=o.device) < rows[:, None]
        o = o * keep[..., None]
    return o.to(x.dtype)


#: the tensor-core variant's tiles and their edges: the transposed decode
#: tile (C <= 8, C <= 16), the row tile past it (C > 16), d and f
#: multiples of 8 only (ragged slices and strips) or of 64
TILE_EDGES = [(3, 1, 64, 64), (3, 1, 24, 8), (2, 9, 64, 128),
              (2, 16, 56, 24), (2, 17, 64, 64), (2, 63, 72, 40),
              (2, 64, 128, 64), (2, 65, 64, 192), (2, 640, 256, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("e,cap,d,f", [
    (4, 32, 48, 24), (2, 64, 32, 64),         # tests/test_kernels.py's sweep
    (3, 20, 40, 16),                          # ragged C (no tile divides it)
    (2, 5, 100, 8),                           # C < 8, d not a vector multiple
    (4, 8, 256, 64),                          # the decode tile (C <= 8)
    *TILE_EDGES,
])
def test_moe_gmm_matches_plain(cuda, e, cap, d, f, act, dtype):
    """tests/test_kernels.py's tolerances: 1e-4 float32, 3e-2 bfloat16;
    each case asserts the variant it launched.  The tile-edge cases draw
    their weights at 1/sqrt(fan in), as chip_smoke.py does: at the sweep's
    fixed 0.2 and d = 256, h reaches ~100, where one bf16 ulp of h (which
    the tensor-core variant rounds h to) moves an output by ~0.1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w1, w2 = _gmm_inputs(
        e, cap, d, f, act, dtype, cuda,
        w_scale=None if (e, cap, d, f) in TILE_EDGES else 0.2)
    x[-1] = 0                                 # an expert with no token
    want = _want_variant(d, dtype)
    before = moe_gmm.launches
    by_variant = dict(moe_gmm.launches_by_variant)
    out = moe_gmm(x, w1, w2, act=act)
    assert moe_gmm.launches == before + 1
    by_variant[want] += 1
    assert moe_gmm.launches_by_variant == by_variant
    torch.cuda.synchronize()
    ref = _plain_of(want, x, w1, w2, act)
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.count_nonzero(out[-1]) == 0
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["swiglu", "relu2"])
@pytest.mark.parametrize("cap,d,f", [(8, 64, 64), (16, 64, 32),
                                     (200, 128, 64), (30, 100, 16)])
def test_moe_gmm_rows_skip_empty_capacity(cuda, cap, d, f, act, dtype):
    """Partial fills, one expert at 0 rows, one full: with ``rows`` the
    output equals, bit for bit, the output without it on inputs zeroed
    past each fill, and rows past a fill are zero whatever the input
    holds there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w1, w2 = _gmm_inputs(5, cap, d, f, act, dtype, cuda, seed=6)
    fill = [cap // 2, 0, cap, 1, cap - 3]
    rows = torch.tensor(fill, dtype=torch.int32, device=cuda)
    zeroed = x.clone()
    for e, n in enumerate(fill):
        zeroed[e, n:] = 0
    want = _want_variant(d, dtype)
    before = moe_gmm.launches_by_variant[want]
    with_rows = moe_gmm(zeroed, w1, w2, act=act, rows=rows)
    without = moe_gmm(zeroed, w1, w2, act=act)
    garbage_past_fill = moe_gmm(x, w1, w2, act=act, rows=rows)
    assert moe_gmm.launches_by_variant[want] == before + 3
    torch.cuda.synchronize()
    assert torch.equal(with_rows, without)
    assert torch.equal(garbage_past_fill, without)
    assert torch.count_nonzero(without[1]) == 0
    ref = _plain_of(want, x, w1, w2, act, rows)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(with_rows.float(), ref.float(), atol=tol,
                               rtol=tol)


def test_moe_gmm_refuses_what_it_does_not_take(cuda):
    x, w1, w2 = _gmm_inputs(2, 8, 32, 16, "swiglu", torch.float32, cuda)
    with pytest.raises(ValueError):
        moe_gmm(x.transpose(1, 2).contiguous().transpose(1, 2), w1, w2)
    with pytest.raises(ValueError):
        moe_gmm(x.half(), w1.half(), w2.half())
    with pytest.raises(ValueError):
        moe_gmm(x, w1.bfloat16(), w2)              # mixed dtypes
    with pytest.raises(ValueError):
        moe_gmm(x, w1, w2, act="gelu")             # w1 is [gate | up]
    with pytest.raises(ValueError):
        moe_gmm(x, w1[..., :20].contiguous(), w2[:, :10].contiguous())
    with pytest.raises(ValueError):
        moe_gmm(x, w1.cpu(), w2)
    for rows in (torch.zeros(2, dtype=torch.int64, device=cuda),  # dtype
                 torch.zeros(3, dtype=torch.int32, device=cuda),  # shape
                 torch.zeros(2, dtype=torch.int32)):              # device
        with pytest.raises(ValueError):
            moe_gmm(x, w1, w2, rows=rows)


# ---------------------------------------------------------------------------
# B5 the SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(bs, h, s, p, g, n, dtype, cuda, *, dt_scale=1.0, seed=5):
    """tests/test_kernels.py::test_ssd_sweep's distributions, dt float32;
    ``dt_scale`` multiplies dt and divides x, so the decays grow while
    dt·x (the scale of y and of its rounding) stays the sweep's."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(bs, h, s, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(bs, h, s, generator=gen))
    a_log = torch.randn(h, generator=gen) * 0.5
    b = torch.randn(bs, g, s, n, generator=gen) * 0.3
    c = torch.randn(bs, g, s, n, generator=gen) * 0.3
    d = torch.randn(h, generator=gen)
    return ((x / dt_scale).to(dtype).to(cuda), (dt * dt_scale).to(cuda),
            a_log.to(cuda),
            b.to(dtype).to(cuda), c.to(dtype).to(cuda), d.to(cuda))


def _ssd_close(out, ref, dtype):
    """tests/test_kernels.py's tolerances: 5e-4 float32, 5e-2 bfloat16."""
    tol = 5e-2 if dtype == torch.bfloat16 else 5e-4
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,h,s,p,g,n,with_h0", [
    (2, 4, 64, 16, 2, 8, False),              # tests/test_kernels.py's sweep
    (1, 4, 128, 32, 1, 16, False),
    (3, 6, 48, 8, 3, 4, False),
    (4, 32, 2048, 64, 1, 128, False),         # mamba2-370m's prefill
    (4, 50, 2048, 64, 1, 16, False),          # hymba-1.5b's prefill
    (1, 8, 1000, 64, 1, 128, True),           # ragged s, an initial state
    (2, 4, 1, 64, 1, 128, True),              # one token
    (1, 6, 100, 40, 2, 256, True),            # P not a multiple of 32, N 256
])
def test_ssd_scan_matches_plain(cuda, bs, h, s, p, g, n, with_h0, dtype):
    x, dt, a_log, b, c, d = _ssd_inputs(bs, h, s, p, g, n, dtype, cuda)
    h0 = torch.randn(bs, h, n, p, device=cuda) if with_h0 else None
    before = ssd_scan_bhsp.launches
    (y, h_final), kind = ssd_variant_of(
        lambda: ssd_scan_bhsp(x, dt, a_log, b, c, d, h0=h0))
    assert ssd_scan_bhsp.launches == before + 1
    assert kind == ssd_variant(x, b) == (
        "tc" if dtype == torch.bfloat16 and p % 16 == 0 and n % 16 == 0
        else "simt")
    torch.cuda.synchronize()
    ref_y, ref_h = ssd_scan_ref(x, dt, a_log, b, c, d, h0=h0)
    assert y.dtype == dtype and y.shape == x.shape
    _ssd_close(y, ref_y, dtype)
    _ssd_close(h_final, ref_h, torch.float32)


#: the tensor-core variant against the plain version of its own rounding
#: (ssd_scan_tc_ref): y within 4e-2 + 1e-2 |ref|, the final state within
#: 1e-4 + 1e-4 |ref|.  The relative part covers y's own bf16 rounding
#: tipped the other way (2^-8); the absolute part one bf16 ulp of an M
#: element that the float32 sums' order tips the other way, times x
#: (~2^-7 |M| |x|, 0.0156 at |y| 0.21 seen at mamba2's shape), which does
#: not scale with y.  The final state is not rounded at all.
SSD_TC_Y_ATOL, SSD_TC_Y_RTOL, SSD_TC_H_TOL = 4e-2, 1e-2, 1e-4


def _ssd_tc_case(cuda, bs, h, s, p, g, n, with_h0, dt_scale=1.0):
    x, dt, a_log, b, c, d = _ssd_inputs(bs, h, s, p, g, n, torch.bfloat16,
                                        cuda, dt_scale=dt_scale)
    h0 = torch.randn(bs, h, n, p, device=cuda) if with_h0 else None
    (y, h_final), kind = ssd_variant_of(
        lambda: ssd_scan_bhsp(x, dt, a_log, b, c, d, h0=h0))
    assert kind == "tc"
    torch.cuda.synchronize()
    ref_y, ref_h = ssd_scan_ref(x, dt, a_log, b, c, d, h0=h0)
    _ssd_close(y, ref_y, torch.bfloat16)
    _ssd_close(h_final, ref_h, torch.float32)
    tc_y, tc_h = ssd_scan_tc_ref(x, dt, a_log, b, c, d, h0=h0)
    torch.testing.assert_close(y.float(), tc_y.float(), atol=SSD_TC_Y_ATOL,
                               rtol=SSD_TC_Y_RTOL)
    torch.testing.assert_close(h_final, tc_h, atol=SSD_TC_H_TOL,
                               rtol=SSD_TC_H_TOL)


@pytest.mark.parametrize("bs,h,s,p,g,n,with_h0", [
    (1, 4, 128, 32, 1, 16, False),            # the sweep's tc shape
    (4, 32, 2048, 64, 1, 128, False),         # mamba2-370m's prefill
    (4, 50, 2048, 64, 1, 16, False),          # hymba-1.5b's prefill
    (1, 8, 1000, 64, 1, 128, True),           # ragged s, an initial state
    (2, 4, 1, 64, 1, 128, True),              # one token
    (1, 6, 300, 128, 2, 256, True),           # the largest P and N
    (2, 4, 200, 16, 2, 16, False),            # the smallest, 2 groups
    (1, 4, 130, 48, 1, 32, True),             # P 48, one row past a chunk
    (2, 4, 0, 64, 1, 128, True),              # no token: h0 carried out
])
def test_ssd_tc_matches_both_plain(cuda, bs, h, s, p, g, n, with_h0):
    """"tc" within the sweep's bf16 tolerance of the per-step recurrence
    (y 5e-2, the final state 5e-4) and within the tighter limits above
    of the plain version of its own rounding."""
    _ssd_tc_case(cuda, bs, h, s, p, g, n, with_h0)


def test_ssd_tc_large_dt_stays_finite(cuda):
    """dt ~ 40 in bf16: exp(cum) underflows within a chunk, M's masked
    exponents would overflow; y stays finite and within both limits."""
    _ssd_tc_case(cuda, 2, 8, 512, 64, 1, 128, False, dt_scale=40.0)


@pytest.mark.parametrize("n", [128, 16])
def test_ssd_tc_fused_views_bitwise(cuda, n):
    """The model's call: the seq-major adapter on x's seq-major view and
    on B and C as column views of one fused projection, y written
    seq-major, is bitwise equal to the kernel-layout call on contiguous
    copies; so is a view off a 16-byte boundary (copied first)."""
    s, bs, h, p = 300, 2, 8, 64
    x, dt, a_log, b, c, d = _ssd_inputs(bs, h, s, p, 1, n, torch.bfloat16,
                                        cuda)
    xs = x.permute(2, 0, 1, 3).contiguous()
    bc = torch.cat([b.permute(2, 0, 1, 3).reshape(s, bs, n),
                    c.permute(2, 0, 1, 3).reshape(s, bs, n)], dim=-1)
    bs_, cs_ = (t.reshape(s, bs, 1, n) for t in bc.chunk(2, dim=-1))
    dts = dt.permute(2, 0, 1).contiguous()
    (y, h_final), kind = ssd_variant_of(
        lambda: ssd_scan(xs, dts, a_log, bs_, cs_, d))
    assert kind == "tc" and y.is_contiguous()
    want_y, want_h = ssd_scan_bhsp(x.contiguous(), dt, a_log, b.contiguous(),
                                   c.contiguous(), d)
    torch.cuda.synchronize()
    assert torch.equal(y.permute(1, 2, 0, 3), want_y)
    assert torch.equal(h_final, want_h)
    flat = torch.empty(1 + x.numel(), dtype=x.dtype, device=cuda)
    off = flat[1:].view(x.shape)
    off.copy_(x)
    (y2, h2), kind = ssd_variant_of(
        lambda: ssd_scan_bhsp(off, dt, a_log, b, c, d))
    torch.cuda.synchronize()
    assert kind == "tc" and torch.equal(y2, want_y) and \
        torch.equal(h2, want_h)


def test_ssd_scan_large_dt_stays_finite(cuda):
    """dt ~ 40 (x / 40): exp(cum) underflows to 0 within a chunk; y stays
    finite and equal to the recurrence."""
    x, dt, a_log, b, c, d = _ssd_inputs(2, 8, 512, 64, 1, 128,
                                        torch.float32, cuda, dt_scale=40.0)
    y, h_final = ssd_scan_bhsp(x, dt, a_log, b, c, d)
    torch.cuda.synchronize()
    ref_y, ref_h = ssd_scan_ref(x, dt, a_log, b, c, d)
    _ssd_close(y, ref_y, torch.float32)
    _ssd_close(h_final, ref_h, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_seq_major_reads_strided_views(cuda, dtype):
    """The seq-major adapter on the model's layout: B and C are column
    views of one fused projection; no copy is made, y is seq-major."""
    x, dt, a_log, b, c, d = _ssd_inputs(2, 8, 300, 64, 2, 16, dtype, cuda)
    xs, dts = x.permute(2, 0, 1, 3).contiguous(), dt.permute(2, 0, 1)
    bc = torch.cat([b.permute(2, 0, 1, 3).reshape(300, 2, 32),
                    c.permute(2, 0, 1, 3).reshape(300, 2, 32)], dim=-1)
    bs_, cs_ = (t.reshape(300, 2, 2, 16) for t in bc.chunk(2, dim=-1))
    y, h_final = ssd_scan(xs, dts.contiguous(), a_log, bs_, cs_, d)
    torch.cuda.synchronize()
    assert y.shape == xs.shape and y.is_contiguous()
    ref_y, ref_h = ssd_scan_ref(x, dt, a_log, b, c, d)
    _ssd_close(y, ref_y.permute(2, 0, 1, 3), dtype)
    _ssd_close(h_final, ref_h, torch.float32)


def test_ssd_scan_refuses_what_it_does_not_take(cuda):
    x, dt, a_log, b, c, d = _ssd_inputs(1, 4, 16, 8, 2, 8, torch.float32,
                                        cuda)
    with pytest.raises(ValueError):
        ssd_scan_bhsp(x.half(), dt, a_log, b.half(), c.half(), d)
    with pytest.raises(ValueError):
        ssd_scan_bhsp(x, dt, a_log, b.bfloat16(), c, d)     # mixed types
    with pytest.raises(ValueError):
        ssd_scan_bhsp(x, dt.bfloat16(), a_log, b, c, d)     # dt not f32
    with pytest.raises(ValueError):
        ssd_scan_bhsp(x, dt[..., :8], a_log, b, c, d)       # s mismatch
    with pytest.raises(ValueError):
        ssd_scan_bhsp(x[:, :3], dt[:, :3], a_log[:3], b, c, d[:3])  # 3 % 2
    big = torch.zeros(1, 2, 16, 300, device=cuda)           # N > 256
    with pytest.raises(ValueError):
        ssd_scan_bhsp(x, dt, a_log, big, big, d)
    with pytest.raises(ValueError):
        ssd_scan_bhsp(x, dt, a_log, b, c, d, h0=torch.zeros(1, 4, 8, 7,
                                                           device=cuda))
    with pytest.raises(ValueError):
        ssd_scan_bhsp(x, dt, a_log.cpu(), b, c, d)
