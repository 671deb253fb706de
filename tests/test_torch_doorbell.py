"""The doorbell stage-copy of the PyTorch port held against the JAX package.

Byte-exact throughout (the path is a copy plus a round-to-nearest-even
cast); NaN is compared by ``isnan``, since NaN bit patterns may
legitimately differ.

* ``pack_payloads`` with numpy and with CPU-tensor bursts gives the
  reference's bytes, sizes and wire dtype over the cases of
  ``tests/test_doorbell_fused.py`` (same-object broadcast, uniform stack,
  ragged zero padding, bf16 only for uniform f32, the bf16 round trip);
* the plain ``stage_copy_ref`` / ``stage_copy_push_ref`` (what a CPU
  tensor runs) equal the reference's ``stage_copy`` / ``stage_copy_push``
  (Pallas in interpret mode on the CPU);
* the CUDA kernel against the plain version is in
  ``tests/test_torch_cuda.py``, which imports no JAX so that it runs on
  the card's machine.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.progress.fabric import payloads_to_bytes as ref_p2b
from repro.kernels import doorbell as ref_db
from repro_torch.core.progress.fabric import check_device
from repro_torch.core.progress.fabric import payloads_to_bytes as port_p2b
from repro_torch.kernels import doorbell as port_db

RNG = np.random.default_rng(11)
SPECIAL = np.array([1e-40, -1e-40, 1e-45, np.inf, -np.inf, -0.0, 0.0,
                    3.4028235e38, -3.4028235e38, 1.0 + 2.0 ** -8,
                    1.0 + 3 * 2.0 ** -8, 65504.0], np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bursts():
    rng = np.random.default_rng(5)
    f = rng.standard_normal(6).astype(np.float32)
    return {
        "same_object": [f] * 5,
        "uniform_f32": [rng.standard_normal(6).astype(np.float32)
                        for _ in range(7)],
        "uniform_i32": [np.full(4, i, np.int32) for i in range(6)],
        "uniform_2d_f64": [np.full((2, 2), i, np.float64) for i in range(5)],
        "ragged_u8": [np.arange(3, dtype=np.uint8),
                      np.arange(7, dtype=np.uint8)],
        "ragged_f32": [np.arange(3, dtype=np.float32),
                       np.arange(5, dtype=np.float32)],
        "special_f32": [rng.choice(SPECIAL, 16).astype(np.float32)
                        for _ in range(4)],
        "special_same": [SPECIAL] * 4,
    }


_CASES = [(name, bf16, kind) for name in _bursts()
          for bf16 in (False, True) for kind in ("numpy", "tensor")]


@pytest.mark.parametrize("name,bf16,kind", _CASES,
                         ids=[f"{n}-bf16{int(b)}-{k}" for n, b, k in _CASES])
def test_pack_payloads_matches_reference(name, bf16, kind):
    bufs = _bursts()[name]
    want, wsizes, wdt = ref.pack_payloads(bufs, wire_bf16=bf16)
    if kind == "numpy":
        got, sizes, dt = port.pack_payloads(bufs, wire_bf16=bf16)
        assert isinstance(got, np.ndarray)
        # the broadcast fast path stays a broadcast, as in the reference
        assert (got.strides[0] == 0) == (want.strides[0] == 0)
    else:
        tbufs = [torch.from_numpy(b) for b in bufs]
        if name.startswith("same") or name == "special_same":
            tbufs = [tbufs[0]] * len(bufs)        # keep object identity
        got, sizes, dt = port.pack_payloads(tbufs, wire_bf16=bf16,
                                            device=torch.device("cpu"))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
        assert (got.stride(0) == 0) == (want.strides[0] == 0)
    assert dt == wdt
    assert np.array_equal(sizes, wsizes) and sizes.dtype == np.int64
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_delivered_payloads_bf16_roundtrip(kind):
    """``delivered_payloads`` restores bf16 rows to f32 bytes exactly as
    the reference does (tests/test_doorbell_fused.py:138-146), for a
    stacked and for a broadcast burst."""
    f32 = np.concatenate([np.linspace(-3, 3, 8, dtype=np.float32),
                          SPECIAL[:8]]).reshape(4, 4)
    for bufs in (list(f32), [f32[0]] * 3):
        rdata, rsizes, rwd = ref.pack_payloads(bufs, wire_bf16=True)
        want = ref.PackedBurst(rdata, rsizes, [0] * len(bufs), len(bufs),
                               rwd).delivered_payloads()
        src = bufs if kind == "numpy" else (
            [torch.from_numpy(b) for b in bufs] if len(bufs) == 4
            else [torch.from_numpy(bufs[0])] * 3)
        data, sizes, wd = port.pack_payloads(src, wire_bf16=True)
        got = port.PackedBurst(data, sizes, [0] * len(bufs), len(bufs),
                               wd).delivered_payloads()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(_np(g), np.asarray(w))


def test_payloads_to_bytes_matches_reference():
    for bufs in (_bursts()["uniform_2d_f64"], _bursts()["ragged_u8"],
                 [np.arange(4, dtype=np.int32),
                  np.arange(2, dtype=np.float64),
                  np.frombuffer(b"0123456789abcdef", np.uint8).copy()]):
        want = ref_p2b(bufs)
        for got in (port_p2b(bufs),
                    port_p2b([torch.from_numpy(np.array(b)) for b in bufs])):
            assert [_np(g).tobytes() for g in got] == \
                [np.asarray(w).tobytes() for w in want]


def test_cuda_payload_on_cpu_runtime_raises():
    class FakeCuda:                      # a CUDA tensor needs a card; the
        is_cuda = True                   # check only reads these fields
        device = torch.device("cuda", 0)
    with pytest.raises(port.FatalError):
        check_device(FakeCuda(), torch.device("cpu"))


def test_tensor_payloads_must_be_contiguous():
    t = torch.arange(16, dtype=torch.float32).reshape(4, 4).t()
    with pytest.raises(port.FatalError):
        port.pack_payloads([t] * 4)


# ---------------------------------------------------------------------------
# plain versions vs the reference kernels (Pallas, interpret mode)
# ---------------------------------------------------------------------------

_DTYPES = [np.float32, np.int32, np.uint8, np.int16]


@pytest.mark.parametrize("dtype", _DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("bf16", [False, True])
def test_stage_copy_ref_matches_reference(dtype, bf16):
    x = (RNG.standard_normal((16, 5)) * 50).astype(dtype)
    want = np.asarray(ref_db.stage_copy(jnp.asarray(x), wire_bf16=bf16))
    got = port_db.stage_copy(torch.from_numpy(x), wire_bf16=bf16)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(port_db.stage_copy_ref(torch.from_numpy(x),
                                                  wire_bf16=bf16).numpy(),
                          want)


def test_stage_copy_ref_special_values_and_nan():
    x = RNG.choice(np.concatenate([SPECIAL, [np.nan, -np.nan]]),
                   (8, 32)).astype(np.float32)
    want = np.asarray(ref_db.stage_copy(jnp.asarray(x), wire_bf16=True))
    got = port_db.stage_copy_ref(torch.from_numpy(x), wire_bf16=True)
    w = want.view(np.uint16)
    g = got.numpy().view(np.uint16)
    wn = (w & 0x7FFF) > 0x7F80
    gn = (g & 0x7FFF) > 0x7F80
    assert np.array_equal(wn, gn) and np.array_equal(wn, np.isnan(x))
    assert np.array_equal(w[~wn], g[~gn])


def test_stage_copy_ref_is_a_snapshot():
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    out = port_db.stage_copy_ref(x)
    x += 1
    assert torch.equal(out.view(torch.float32),
                       torch.arange(8, dtype=torch.float32).reshape(2, 4))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("grab", ["full", "short"])
def test_stage_copy_push_ref_matches_reference(bf16, grab):
    """tests/test_doorbell_fused.py:240-251, plus a short grab where only
    the ``got`` prefix may change."""
    x = RNG.standard_normal((4, 3)).astype(np.float32)
    ppl = 8 if grab == "full" else 3
    buf0 = RNG.integers(0, 256, (8, 32)).astype(np.uint8)
    rp = ref.init_pool(n_lanes=1, packets_per_lane=ppl)
    tp = port.init_pool(1, ppl, device="cpu")
    rp, rbuf, rids, rgot, rst = ref_db.stage_copy_push(
        rp, jnp.asarray(buf0), 0, jnp.asarray(x), 0, wire_bf16=bf16)
    tp, tbuf, tids, tgot, tst = port_db.stage_copy_push(
        tp, torch.from_numpy(buf0.copy()), 0, torch.from_numpy(x), 0,
        wire_bf16=bf16)
    assert np.array_equal(np.asarray(rbuf), tbuf.numpy())
    assert np.array_equal(np.asarray(rids), tids.numpy())
    assert int(rgot) == int(tgot) == (4 if grab == "full" else 3)
    assert int(rst) == int(tst)
    assert np.array_equal(np.asarray(rp.slots), tp.slots.numpy())


# ---------------------------------------------------------------------------
# the gather: K separate rows, as the main path's fused doorbell stages them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k", [1, 64, 257])
def test_stage_copy_rows_matches_reference(dtype, bf16, k):
    """The gather of K row tensors (the plain version on the CPU) equals
    the reference's ``stage_copy`` of the stacked (K, E) array."""
    x = (RNG.standard_normal((k, 6)) * 50).astype(dtype)
    want = np.asarray(ref_db.stage_copy(jnp.asarray(x), wire_bf16=bf16))
    rows = [torch.from_numpy(r.copy()) for r in x]   # separate tensors
    got = port_db.stage_copy_rows(rows, wire_bf16=bf16)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(
        port_db.stage_copy_rows_ref(rows, wire_bf16=bf16).numpy(), want)


@pytest.mark.parametrize("bf16", [False, True])
def test_pack_payloads_of_strided_rows_matches_reference(bf16):
    """Distinct non-contiguous rows (columns of a matrix) take the uniform
    branch and pack to the reference's bytes."""
    m = (RNG.standard_normal((6, 5)) * 50).astype(np.float32)
    bufs = [np.ascontiguousarray(c) for c in m.T]
    want, wsizes, wdt = ref.pack_payloads(bufs, wire_bf16=bf16)
    tbufs = list(torch.from_numpy(m).t())
    assert not any(t.is_contiguous() for t in tbufs)
    got, sizes, dt = port.pack_payloads(tbufs, wire_bf16=bf16,
                                        device=torch.device("cpu"))
    assert dt == wdt and np.array_equal(sizes, wsizes)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("odd", ["dtype", "shape", "device", "not_a_tensor",
                                 "empty"])
def test_stage_copy_rows_refuses_mixed_rows(odd):
    rows = [torch.zeros(4) for _ in range(3)]
    if odd == "dtype":
        rows[1] = torch.zeros(4, dtype=torch.float64)
    elif odd == "shape":
        rows[2] = torch.zeros(2, 2)
    elif odd == "device":
        rows[1] = torch.zeros(4, device="meta")
    elif odd == "not_a_tensor":
        rows[1] = np.zeros(4, np.float32)
    else:
        rows = []
    with pytest.raises(ValueError):
        port_db.stage_copy_rows(rows)
    assert not port_db.uniform_rows(rows)


@pytest.mark.parametrize("k", [1, 3])
def test_uniform_rows_accepts_one_dtype_shape_device(k):
    rows = [torch.zeros(2, 3, dtype=torch.int32) for _ in range(k)]
    assert port_db.uniform_rows(rows)
    assert port_db.uniform_rows(tuple(rows))


def test_oversize_row_raises():
    tp = port.init_pool(1, 2, device="cpu")
    buf = port.init_buffers(2, 8, device="cpu")
    with pytest.raises(ValueError):
        port_db.stage_copy_push(tp, buf, 0, torch.zeros((1, 3),
                                                        dtype=torch.float32),
                                0)
    with pytest.raises(ValueError):
        port_db.stage_copy(torch.zeros(4))            # not (k, e)
