"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here is marked ``gpu`` and skips without a CUDA card (the
decision is taken in a fixture, never at import).  The file imports no
JAX, so it runs on the card's machine, which has none:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

``chip_smoke.py`` holds the same kernel at the main path's shapes and
drives the whole message path.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import FatalError, LocalCluster
from repro_torch.core.packet_pool import init_buffers, init_pool
from repro_torch.kernels import doorbell as db

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


def test_main_path_launches_once_per_doorbell(cuda):
    cl = LocalCluster(2, device=cuda, attrs={"wire_bf16": True})
    ep0, ep1 = cl.alloc_endpoint(n_devices=2)
    cq = cl[1].alloc_cq()
    rc = cl[1].register_rcomp(cq)
    src = torch.randn(8, 64, device=cuda)
    before = db.stage_copy.launches
    sts = ep0.post_am_many(1, list(src), rc, tags=list(range(8)))
    assert all(s.is_done() for s in sts)
    assert db.stage_copy.launches == before + 1
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
