"""The port's token pipeline (``data/pipeline.py``) on the CPU against the
JAX package's ``repro.data.pipeline``: synthetic batches equal for several
steps and shards (and codebooks), the file-backed pipeline on a uint16
token file, and the ``Prefetcher`` resuming at a step.  Bar: equal arrays.
"""
import numpy as np
import pytest

from repro.data import pipeline as ref_pipe

from repro_torch.data import pipeline


def _cfgs(**kw):
    return ref_pipe.DataConfig(**kw), pipeline.DataConfig(**kw)


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("shards,codebooks", [(1, 0), (2, 0), (4, 0),
                                              (1, 2)])
def test_synthetic_batches_equal_the_reference(shards, codebooks):
    for shard in range(shards):
        ref_cfg, cfg = _cfgs(vocab_size=301, seq_len=23, global_batch=8,
                             num_shards=shards, shard_id=shard, seed=5,
                             num_codebooks=codebooks)
        ref, port = ref_pipe.make_pipeline(ref_cfg), pipeline.make_pipeline(
            cfg)
        assert isinstance(port, pipeline.SyntheticLM)
        for step in (0, 1, 2, 7, 100):
            _equal(port.batch_at(step), ref.batch_at(step))


def test_iteration_equals_batch_at():
    _, cfg = _cfgs(vocab_size=64, seq_len=9, global_batch=2, seed=1)
    src = pipeline.SyntheticLM(cfg)
    for step, batch in zip(range(3), src):
        _equal(batch, src.batch_at(step))


def test_file_backed_equals_the_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 70000, size=5000).astype(
        np.uint16).tofile(path)
    for shards in (1, 2):
        for shard in range(shards):
            ref_cfg, cfg = _cfgs(vocab_size=50000, seq_len=31,
                                 global_batch=4, num_shards=shards,
                                 shard_id=shard, path=str(path))
            ref, port = ref_pipe.make_pipeline(ref_cfg), \
                pipeline.make_pipeline(cfg)
            assert isinstance(port, pipeline.FileBackedLM)
            for step in (0, 1, 5, 40):
                _equal(port.batch_at(step), ref.batch_at(step))


def test_file_too_small_raises(tmp_path):
    path = tmp_path / "tiny.bin"
    np.arange(10, dtype=np.uint16).tofile(path)
    with pytest.raises(ValueError, match="too small"):
        pipeline.FileBackedLM(pipeline.DataConfig(
            vocab_size=10, seq_len=8, global_batch=2, path=str(path)))


def test_shard_batch_must_divide():
    with pytest.raises(ValueError, match="multiple"):
        pipeline.DataConfig(vocab_size=10, seq_len=8, global_batch=3,
                            num_shards=2).shard_batch


def test_prefetcher_resumes_at_a_step():
    ref_cfg, cfg = _cfgs(vocab_size=128, seq_len=15, global_batch=2, seed=9)
    ref = ref_pipe.SyntheticLM(ref_cfg)
    pf = pipeline.Prefetcher(pipeline.SyntheticLM(cfg), start_step=6,
                             depth=2)
    try:
        for want_step in (6, 7, 8):
            step, batch = pf.get()
            assert step == want_step
            _equal(batch, ref.batch_at(step))
    finally:
        pf.close()
    assert not pf._thread.is_alive()
