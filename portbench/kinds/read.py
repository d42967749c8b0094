"""Reads, closed loop with one client.

Set-up loads every version of a chain of ``config["n_versions"]``, then
warms the read path up with ``mix["warm_requests"]`` requests of their own.
The window sends the mix's ``mix["requests"]`` requests in turn (each a wave
of queries at one version through ``StoreQueryEngine.serve``, timed from
the call to the answers on the host), the next when the last has come back,
and closes with the first request that ends after ``seconds``.  Every
answer of the window is checked; nothing is read back.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.harness import arith, gen
from portbench.harness.context import Run, Window, log
from portbench.harness.spans import clock


def plan(config: Dict, mix: Dict, seconds: float) -> Tuple[List[int], int]:
    n = int(config["n_versions"])
    return gen.chain(n), n


def requests(mix: Dict, log_: gen.OpLog, seed: int
             ) -> Tuple[List[Tuple], List[Tuple]]:
    """The window's requests, sent in turn, and the warm-up's own."""
    return (gen.read_requests(mix, log_, seed, int(mix["requests"])),
            gen.read_requests(mix, log_, seed, int(mix["warm_requests"]),
                              stream=3))


def prepare(run: Run) -> None:
    from repro_torch.serve.engine import StoreQueryEngine
    engine = StoreQueryEngine(run.rs)
    run.versions = None                # the load's copies are done with
    timed, warm = requests(run.mix, run.log, run.seed)
    run.state.update(engine=engine, requests=timed,
                     batches=[gen.to_queries(run.T.Q, r, run.stale)
                              for r in timed])
    for r in warm:
        engine.serve(gen.to_queries(run.T.Q, r))


def _n_records(value) -> int:
    if value is None:
        return 0
    if isinstance(value, (dict, list)):
        return len(value)
    return 1


def window(run: Run, win: Window, seconds: float) -> None:
    engine, requests, batches, sync = (run.state["engine"],
                                       run.state["requests"],
                                       run.state["batches"], run.sync)
    deadline = clock() + seconds
    i = 0
    while True:
        j = i % len(batches)
        t0 = clock()
        try:
            batch = engine.serve(batches[j])
            sync()
            values = [r.value for r in batch]
        except Exception as e:        # a request that fails is counted
            log(f"request {i} failed: {e!r}")
            values = None
            win.failed += 1
        t1 = clock()
        win.latencies.append(t1 - t0)
        win.attempted += 1
        if values is not None:
            win.units += 1
            win.records += sum(_n_records(v) for v in values)
            win.answers.append((requests[j], values))
        i += 1
        if t1 >= deadline:
            return


def written(run: Run, win: Window) -> int:
    return run.loaded


def readback(run: Run, win: Window) -> list:
    return []


def measure(win: Window) -> Dict[str, float]:
    if not win.latencies:
        return {}
    return {"read_p95_ms": 1e3 * arith.nearest_rank(win.latencies, 95),
            "read_records_per_s": win.records / win.seconds}
