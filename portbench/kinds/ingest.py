"""Ingest, closed loop with one writer continuing the chain.

Set-up loads the root and ``mix["warm_sessions"]`` writer sessions of
``mix["session_versions"]`` commits each.  The window writes further
sessions of that many commits, each acknowledged when its ``close()``
returns (the group flush is durable), the next when the last has been
acknowledged, and closes with the first session acknowledged after
``seconds``.  The op log holds enough versions for
``mix["headroom_records_per_s"]`` over the window.  After it, the
acknowledged versions are read back from each copy the stack keeps.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from portbench.harness import gen, store
from portbench.harness.context import Run, Window, log, read_every_copy
from portbench.harness.spans import clock


def plan(config: Dict, mix: Dict, seconds: float) -> Tuple[List[int], int]:
    n_base, data = int(config["n_base_records"]), config["data"]
    per_version = max(1, int(n_base * float(data["pct_update"])))
    S = int(mix["session_versions"])
    warm = int(mix["warm_sessions"]) * S
    need = float(mix["headroom_records_per_s"]) * seconds / per_version
    n_window = S * (int(need) // S + 1)
    return gen.chain(1 + warm + n_window), 1 + warm


def prepare(run: Run) -> None:
    pass


def window(run: Run, win: Window, seconds: float) -> None:
    S, versions, log_ = int(run.mix["session_versions"]), run.versions, \
        run.log
    deadline = clock() + seconds
    nxt = run.loaded
    while True:
        sess = versions[nxt:nxt + S]
        if len(sess) < S:
            log("the pregenerated versions ran out before the window closed")
            return
        win.attempted += S
        try:
            store.write_session(run.rs, sess, nxt)
            run.sync()
        except Exception as e:
            log(f"session of versions {nxt}..{nxt + S - 1} failed: {e!r}")
            win.failed += S
            return
        t1 = clock()
        win.units += S
        win.records += sum(log_.records_of(v) for v in range(nxt, nxt + S))
        nxt += S
        if t1 >= deadline:
            return


def written(run: Run, win: Window) -> int:
    return run.loaded + win.units


def readback_queries(mix: Dict, log_, seed: int, first: int, last: int
                     ) -> Tuple:
    """The read-back of an ingest window: the newest acknowledged version
    whole, a sample of the window's other versions whole, and the evolution
    of a sample of base keys (all drawn from the seed)."""
    rb = mix["readback"]
    rng = gen.rng_for(seed, 4)
    vids = [last]
    if last > first:
        pool = np.arange(first, last)
        vids += sorted(int(v) for v in rng.choice(
            pool, size=min(int(rb["versions"]) - 1, len(pool)),
            replace=False))
    keys = rng.choice(log_.n_base, size=int(rb["evolution_keys"]),
                      replace=False)
    return tuple([("version", v) for v in vids]
                 + [("evolution", int(k)) for k in keys])


def readback(run: Run, win: Window) -> list:
    last = written(run, win) - 1
    return read_every_copy(run, readback_queries(run.mix, run.log, run.seed,
                                                 run.loaded, last))


def measure(win: Window) -> Dict[str, float]:
    if win.seconds <= 0:
        return {}
    return {"ingest_records_per_s": win.records / win.seconds}
