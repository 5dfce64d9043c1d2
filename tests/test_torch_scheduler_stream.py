"""The reference's acceptance stream (tests/test_scheduler.py) on the
port's scheduler: 200 mixed-shape requests across ≥ 3 buckets with no
program built after the warmup — by the cache's counter and by
``batched.ClassifyProgram.builds`` — and every completion bit-equal to
its ``one_shot`` run.  A file of its own, so the test workers share
the scheduler tests' time.
"""

import torch

from repro_torch.core import batched

from test_torch_scheduler import (LATTICE, _assert_one_shot_parity, _sched,
                                  _stream)

torch.set_num_threads(1)


def test_stream_200_requests_zero_recompiles_bitwise_parity():
    reqs = _stream(200)
    with _sched(lattice=LATTICE, policy="pack") as sched:
        sched.warm(reqs, b_sizes=LATTICE.b_sizes + (1,))  # +B=1: one_shot
        warm_compiles = sched.cache.stats.compiles
        assert warm_compiles > 0
        builds0 = batched.ClassifyProgram.builds
        done = sched.run_stream(reqs)
        assert len(done) == len(reqs)
        buckets = {(c.bucket.B, c.bucket.mloc) for c in done}
        assert len(buckets) >= 3, buckets
        # zero builds in steady state, by the cache's counter and by the
        # engine's own count of programs built
        assert sched.cache.stats.compiles == warm_compiles
        assert sched.cache.stats.misses == warm_compiles
        assert sched.cache.stats.hits >= sched.stats.dispatches
        assert batched.ClassifyProgram.builds == builds0
        for c in done:
            _assert_one_shot_parity(sched, c)
        assert sched.cache.stats.compiles == warm_compiles
        assert batched.ClassifyProgram.builds == builds0
