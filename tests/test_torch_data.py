"""The port's step-indexed data pipelines (``repro_torch/data/
pipeline.py``) against the reference's: both pipelines' batches bit-equal
over 8 steps and 2 seeds, as int32 tensors on the device asked for, and
the frontend stubs equal."""
import numpy as np
import pytest
import torch

from repro.data import pipeline as r_pipeline

from repro_torch.core.status import FatalError
from repro_torch.data import (SyntheticPipeline, TokenFilePipeline,
                              stub_frames, stub_image_embeds)

STEPS = range(8)


def _equal(batch, ref):
    assert sorted(batch) == sorted(ref) == ["labels", "tokens"]
    for k in ref:
        assert batch[k].dtype == torch.int32 and batch[k].device.type == "cpu"
        assert np.array_equal(batch[k].numpy(), ref[k]), k


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_bit_equal(seed):
    kw = dict(vocab=512, seq_len=40, global_batch=3, seed=seed)
    pipe = SyntheticPipeline(**kw)
    ref = r_pipeline.SyntheticPipeline(**kw)
    for step in STEPS:
        _equal(pipe.get_batch(step, device="cpu"), ref.get_batch(step))
    # a replay after a restore gives the same batch again
    _equal(pipe.get_batch(3, device="cpu"), ref.get_batch(3))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_token_file_bit_equal(tmp_path, seed, dtype):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(seed).integers(
        0, 70000 if dtype == "uint32" else 60000, 5000).astype(dtype).tofile(
        path)
    kw = dict(path=path, vocab=50000, seq_len=32, global_batch=4,
              dtype=dtype, seed=seed)
    pipe = TokenFilePipeline(**kw)
    ref = r_pipeline.TokenFilePipeline(**kw)
    for step in STEPS:
        _equal(pipe.get_batch(step, device="cpu"), ref.get_batch(step))


def test_token_file_too_small(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.arange(50, dtype=np.uint16).tofile(path)
    with pytest.raises(ValueError, match="too small"):
        TokenFilePipeline(path, vocab=100, seq_len=16, global_batch=4)


def test_batches_name_the_card_by_default():
    """Without a card, a batch with no device raises instead of landing
    on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(FatalError, match="no CUDA device"):
        SyntheticPipeline(vocab=64, seq_len=8, global_batch=2).get_batch(0)


@pytest.mark.parametrize("step", [0, 5])
def test_stubs_equal(step):
    assert np.array_equal(stub_image_embeds(6, 2, 16, step),
                          r_pipeline.stub_image_embeds(6, 2, 16, step))
    assert np.array_equal(stub_frames(10, 2, 16, step),
                          r_pipeline.stub_frames(10, 2, 16, step))
