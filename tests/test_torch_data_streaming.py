"""Data executor on streaming generators: blocks leave read/map tasks as
they are produced, so one task's output never has to fit in memory at
once (reference: streaming_executor_state.py + generator block returns).

The port's mirror of tests/test_data_streaming.py, case by case, on one
cluster of the port's runtime for the module.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.block import rows_to_block, BlockMetadata
from ray_tpu_torch.data.datasource import Datasource, ReadTask


@pytest.fixture(scope="module")
def ray_cluster():
    """One cluster of the port's runtime for the module, under the name of
    the reference's session fixture (tests/conftest.py)."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


class SlowMultiBlockSource(Datasource):
    """One read task that yields `n_blocks` blocks with a delay between
    them — the probe for streaming: a buffering executor sees nothing
    until the task ends; a streaming one sees early blocks immediately."""

    def __init__(self, n_blocks: int, delay_s: float):
        self._n = n_blocks
        self._delay = delay_s

    def get_read_tasks(self, parallelism):
        n, delay = self._n, self._delay

        def read():
            for i in range(n):
                if i:
                    time.sleep(delay)
                yield rows_to_block([{"i": i}])

        return [ReadTask(read, BlockMetadata(num_rows=n, size_bytes=None,
                                             input_files=None,
                                             exec_stats=None))]


def test_first_block_arrives_before_read_task_ends(ray_cluster):
    ds = rd.read_datasource(SlowMultiBlockSource(6, 1.0))
    t0 = time.time()
    it = iter(ds.iter_rows())
    first = next(it)
    first_latency = time.time() - t0
    # the whole task takes >= 5s; the first block must not wait for it
    assert first["i"] == 0
    assert first_latency < 4.0, \
        f"first block took {first_latency:.1f}s — output was buffered"
    rest = [r["i"] for r in it]
    assert rest == [1, 2, 3, 4, 5]


def test_streaming_map_preserves_results(ray_cluster):
    ds = rd.range(100, override_num_blocks=8).map(lambda r: {"x": r["id"] * 2})
    vals = sorted(r["x"] for r in ds.take_all())
    assert vals == [2 * i for i in range(100)]


def test_streaming_off_still_works(ray_cluster):
    ctx = rd.DataContext.get_current()
    old = ctx.use_streaming_generators
    ctx.use_streaming_generators = False
    try:
        ds = rd.range(20, override_num_blocks=4).map(
            lambda r: {"x": r["id"] + 1})
        assert sorted(r["x"] for r in ds.take_all()) == list(range(1, 21))
    finally:
        ctx.use_streaming_generators = old
