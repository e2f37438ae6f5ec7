"""The port's input pipeline off the round (``acco_tpu_torch/data/prefetch.py``)
against JAX's (``acco_tpu/data/prefetch.py``), the counterparts of
``tests/test_prefetch.py:46-190``:

- ``AsyncPrefetcher``: order, the worker's exception on the consumer, a
  ``close()`` that does not deadlock on a full queue, idempotent close,
  the depth check;
- ``PrefetchingBlockSource``: prefetched blocks equal synchronous ones and
  JAX's source's blocks; ``iter_state`` is the consumed position, not the
  prefetched one; a source restored from it replays the stream; the
  loader's errors (a raising row, the resume-mismatch check) reach the
  consumer; ``prefetch=False`` starts no thread;
- through the ``Trainer``: ``prefetch`` on and off give bit-equal final
  states for ``acco`` and ``ddp``, a run stopped mid-epoch with blocks in
  the queue resumes bit-exactly, and a worker's error ends ``train()``.

The card's half (pinned blocks, the copy stream and its event) runs in
``chip_smoke.py`` phase 9; on the CPU the worker runs
``block_from_numpy``.
"""

import time

import numpy as np
import pytest
import torch

from acco_tpu.data.loader import ShardedBatchIterator as JaxIterator
from acco_tpu.data.prefetch import PrefetchingBlockSource as JaxSource
from acco_tpu_torch.configuration import ConfigNode
from acco_tpu_torch.data.loader import ShardedBatchIterator
from acco_tpu_torch.data.prefetch import AsyncPrefetcher, PrefetchingBlockSource, block_source
from acco_tpu_torch.data.tokenizer import load_tokenizer
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.parallel.common import MicrobatchBlock
from acco_tpu_torch.trainer import Trainer
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored


def _rows(n, length=6):
    return [list(range(i, i + length)) for i in range(n)]


def _loader(n=24, batch_size=2, seed=7, **kw):
    return ShardedBatchIterator(_rows(n), batch_size=batch_size, max_length=6, pad_token_id=0,
                                seed=seed, **kw)


def _wait_until(cond, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _same(a: dict, b: dict, keys=None):
    for k in keys or a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class TestAsyncPrefetcher:
    def test_yields_in_order_and_stops(self):
        p = AsyncPrefetcher(iter(range(10)), depth=3)
        assert list(p) == list(range(10))
        p.close()

    def test_exception_propagates_to_consumer(self):
        def gen():
            yield 1
            raise RuntimeError("worker boom")

        p = AsyncPrefetcher(gen(), depth=2)
        assert next(p) == 1
        with pytest.raises(RuntimeError, match="worker boom"):
            next(p)
        p.close()

    def test_close_with_full_queue_does_not_deadlock(self):
        def gen():
            i = 0
            while True:
                yield i
                i += 1

        p = AsyncPrefetcher(gen(), depth=2)
        assert _wait_until(lambda: p._queue.full())
        t0 = time.monotonic()
        p.close()
        assert time.monotonic() - t0 < 5.0
        assert not p.alive

    def test_close_is_idempotent_and_next_after_close_raises(self):
        p = AsyncPrefetcher(iter(range(3)), depth=2)
        p.close()
        p.close()
        with pytest.raises(RuntimeError, match="closed"):
            next(p)

    def test_bad_depth_rejected(self):
        with pytest.raises(ValueError, match="depth"):
            AsyncPrefetcher(iter(()), depth=0)


class TestPrefetchingBlockSource:
    def test_prefetched_stream_matches_sync_and_jax(self):
        """10 blocks (an epoch is 6): the prefetched source, the
        synchronous one and JAX's prefetching source give the same blocks
        and positions; the port's carry the ``valid`` column."""
        sync = PrefetchingBlockSource(_loader(), 2, dict, depth=2, prefetch=False)
        pre = PrefetchingBlockSource(_loader(), 2, dict, depth=2)
        jax_loader = JaxIterator([{"input_ids": r} for r in _rows(24)], batch_size=2,
                                 max_length=6, pad_token_id=0, seed=7)
        jax_src = JaxSource(jax_loader, 2, dict, depth=2)
        try:
            for _ in range(10):
                a, b, j = sync.next_block(), pre.next_block(), jax_src.next_block()
                _same(a, b)
                _same(b, j, keys=("input_ids", "attention_mask", "labels"))
                np.testing.assert_array_equal(b["valid"], np.ones(2, np.float32))
                assert sync.iter_state() == pre.iter_state() == jax_src.iter_state()
        finally:
            pre.close()
            jax_src.close()

    def test_iter_state_is_consumed_position_not_prefetched(self):
        loader = _loader()
        src = PrefetchingBlockSource(loader, 2, dict, depth=2)
        try:
            src.next_block()  # batches 0-1
            assert _wait_until(lambda: loader.iter_state()["batch_pos"] > 2
                               or loader.iter_state()["epoch"] > 0)
            assert src.iter_state() == {"epoch": 0, "batch_pos": 2}
        finally:
            src.close()

    def test_resume_from_consumed_state_replays_identical_stream(self):
        ref = PrefetchingBlockSource(_loader(), 2, dict, depth=2, prefetch=False)
        stream = [ref.next_block() for _ in range(10)]
        src = PrefetchingBlockSource(_loader(), 2, dict, depth=2)
        try:
            for _ in range(4):
                src.next_block()
            state = src.iter_state()  # blocks 5.. sit prefetched, uncounted
        finally:
            src.close()
        restored = _loader()
        restored.set_state(state)
        res = PrefetchingBlockSource(restored, 2, dict, depth=2)
        try:
            for want in stream[4:]:
                _same(want, res.next_block())
        finally:
            res.close()

    def test_worker_exception_surfaces(self):
        class Boom:
            def __len__(self):
                return 8

            def __getitem__(self, i):
                if i >= 4:
                    raise RuntimeError("bad row")
                return [1, 2, 3]

        loader = ShardedBatchIterator(Boom(), batch_size=2, max_length=6, pad_token_id=0,
                                      shuffle=False)
        src = PrefetchingBlockSource(loader, 1, dict, depth=2)
        try:
            with pytest.raises(RuntimeError, match="bad row"):
                for _ in range(8):
                    src.next_block()
        finally:
            src.close()

    def test_loader_resume_mismatch_surfaces(self):
        loader = _loader()  # 12 batches an epoch
        loader.set_state({"epoch": 0, "batch_pos": 99})
        src = PrefetchingBlockSource(loader, 1, dict, depth=2)
        try:
            with pytest.raises(ValueError, match="resume skip"):
                src.next_block()
        finally:
            src.close()

    def test_prefetch_false_has_no_worker(self):
        src = PrefetchingBlockSource(_loader(), 1, dict, depth=2, prefetch=False)
        assert src._worker is None
        src.close()  # a no-op

    def test_stress_under_a_short_switch_interval(self):
        """The worker and the consumer hand blocks and positions over at a
        thread switch every microsecond, with more sources than cores:
        every source's stream and positions equal the synchronous ones."""
        import os
        import sys

        ref = PrefetchingBlockSource(_loader(), 2, dict, prefetch=False)
        want = [(ref.next_block(), ref.iter_state()) for _ in range(40)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        sources = [PrefetchingBlockSource(_loader(), 2, dict, depth=1 + i % 3)
                   for i in range(2 * (os.cpu_count() or 1) + 1)]
        try:
            t0 = time.monotonic()
            for block, state in want:
                for src in sources:
                    _same(block, src.next_block())
                    assert src.iter_state() == state
            assert time.monotonic() - t0 < 60
        finally:
            sys.setswitchinterval(interval)
            for src in sources:
                src.close()
        assert not any(src._worker.alive for src in sources)

    @pytest.mark.parametrize("prefetch", [True, False])
    def test_trainer_source_gives_device_blocks(self, prefetch):
        """The trainer's source on the CPU: ``MicrobatchBlock``s of the
        round's dtypes, the same values as the loader's numpy blocks, the
        rank's ``valid`` column in place."""
        valid = np.asarray([1.0, 0.0], np.float32)
        src = block_source(_loader(), 2, "cpu", depth=2, prefetch=prefetch, valid=valid)
        ref = PrefetchingBlockSource(_loader(), 2, dict, prefetch=False, valid=valid)
        try:
            for _ in range(3):
                blk, want = src.next_block(), ref.next_block()
                assert isinstance(blk, MicrobatchBlock)
                assert [t.dtype for t in blk] == [torch.long, torch.int32, torch.long,
                                                  torch.float32]
                for name in want:
                    np.testing.assert_array_equal(getattr(blk, name).numpy(), want[name])  # lint: host-sync-ok: a CPU tensor read in an assertion loop
        finally:
            src.close()


# -- through the Trainer -------------------------------------------------------

ARCH = dict(vocab_size=257, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2,
            num_kv_heads=2, max_position_embeddings=32)
# 7 documents of 63 bytes + EOS: 14 packed rows of 32, 7 batches of 2 an epoch
TEXTS = ["".join(np.random.default_rng(i).choice(list("abcdefghij "), 63)) for i in range(7)]


def _trainer(method, nb, run_dir, **over):
    args = dict(method_name=method, batch_size=2, max_length=32, nb_steps_tot=nb,
                const_len_batch=True, scheduler_name="constant", learning_rate=3e-3,
                weight_decay=0.1, adam_beta1=0.9, adam_beta2=0.95, save=False,
                checkpoint_every_s=1e9, ckpt_async=False, run_name=method)
    args.update(over)
    model = LlamaModel(LlamaConfig(**ARCH), dtype=torch.float32)
    return Trainer(model, load_tokenizer("byte"), TEXTS, None, ConfigNode.wrap(args), seed=3,
                   run_dir=str(run_dir))


def _state_leaves(state):
    out = {}
    for name, value in zip(state._fields, state):
        if isinstance(value, tuple):
            out.update({f"{name}/{k}": v for k, v in _state_leaves(value).items()})
        else:
            out[name] = value.numpy()  # lint: host-sync-ok: a CPU tensor read in an assertion loop
    return out


def _assert_same_state(a, b):
    la, lb = _state_leaves(a), _state_leaves(b)
    assert la.keys() == lb.keys()
    for key in la:
        np.testing.assert_array_equal(lb[key], la[key], err_msg=key)


@pytest.mark.parametrize("method", ["ddp", "acco"])
def test_trainer_prefetch_parity_bitexact(tmp_path, method):
    """``prefetch: false`` (the synchronous opt-out) and the default give
    the same blocks: the final state and the round losses are
    bit-equal across an epoch boundary."""
    pre = _trainer(method, 10, tmp_path / "pre")
    s_pre = pre.train()
    sync = _trainer(method, 10, tmp_path / "sync", prefetch=False)
    s_sync = sync.train()
    assert s_pre["prefetch"] is True and s_sync["prefetch"] is False
    _assert_same_state(pre.final_state, sync.final_state)
    assert [r["loss"] for r in s_pre["round_log"]] == [r["loss"] for r in s_sync["round_log"]]
    assert not pre.source._worker.alive  # closed when train() returned


def test_resume_with_blocks_in_the_queue_is_bitexact(tmp_path):
    """``dpu`` stopped mid-epoch at depth 2 (the worker has collated ahead
    of the last consumed block): the checkpoint holds the consumed
    position, and the resumed run's final state equals an uninterrupted
    run's."""
    a = _trainer("dpu", 6, tmp_path / "a", prefetch_depth=2)
    a.train()
    b = _trainer("dpu", 3, tmp_path / "b", prefetch_depth=2, save=True)
    sb = b.train()
    assert b.loader.iter_state() != b.source.iter_state()  # the worker ran ahead
    assert b.source.iter_state() == {"epoch": 0, "batch_pos": 4}  # seed + 3 rounds
    c = _trainer("dpu", 6, tmp_path / "c", prefetch_depth=2,
                 resume_from=str(tmp_path / "b" / "checkpoints" / "dpu"))
    c.train()
    assert sb["checkpoint"]
    _assert_same_state(a.final_state, c.final_state)


def test_worker_error_ends_train(tmp_path):
    """A resume position that does not fit the data raises on the worker;
    ``train()`` raises it and leaves no worker behind."""
    t = _trainer("dpu", 4, tmp_path)
    t.loader.set_state({"epoch": 0, "batch_pos": 99})
    with pytest.raises(ValueError, match="resume skip"):
        t.train()
    assert not t.source._worker.alive
