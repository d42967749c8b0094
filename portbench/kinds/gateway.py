"""Gateway ingest, for a mix whose ``kind`` is ``"gateway"``:
``mix["clients"]`` named clients, each writing a line of its own through
one ``IngestGateway``, closed loop.

Set-up loads the root and ``mix["warm_versions"]`` commits on it as a chain,
then opens the gateway, which attaches a ``BackgroundFlusher`` to the store.
Every client's line starts at the chain's head, so the versions form a tree.
The window runs rounds: in each, every client in turn stages the next
version of its line, then one ``barrier()`` drains all clients' staged
versions together, and the round's versions are acknowledged when it
returns.  The window closes with the first round acknowledged after
``seconds``; the op log holds enough rounds for
``mix["headroom_records_per_s"]``.  After it, the newest version of each
line, a sample of the window's others and the evolution of a sample of base
keys are read back from each copy the stack keeps.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from portbench.harness import gen
from portbench.harness.context import Run, Window, log, read_every_copy
from portbench.harness.spans import clock


def plan(config: Dict, mix: Dict, seconds: float) -> Tuple[List[int], int]:
    n_base, data = int(config["n_base_records"]), config["data"]
    per_version = max(1, int(n_base * float(data["pct_update"])))
    C = int(mix["clients"])
    loaded = 1 + int(mix["warm_versions"])
    need = float(mix["headroom_records_per_s"]) * seconds / per_version
    parents = gen.chain(loaded)
    for r in range(int(need) // C + 1):
        for c in range(C):
            vid = loaded + r * C + c
            parents.append(loaded - 1 if r == 0 else vid - C)
    return parents, loaded


def prepare(run: Run) -> None:
    from repro_torch.serve.ingest_gateway import IngestGateway
    run.state["gateway"] = IngestGateway(run.rs)


def window(run: Run, win: Window, seconds: float) -> None:
    gw, versions, C = run.state["gateway"], run.versions, \
        int(run.mix["clients"])
    deadline = clock() + seconds
    nxt = run.loaded
    while True:
        if nxt + C > len(versions):
            log("the pregenerated versions ran out before the window closed")
            return
        win.attempted += C
        try:
            for c in range(C):
                parent, adds, dels = versions[nxt + c]
                vid = gw.commit(f"client{c}", [parent], adds, dels)
                if vid != nxt + c:
                    raise RuntimeError(f"the store numbered version "
                                       f"{nxt + c} as {vid}")
            gw.barrier()
            run.sync()
        except Exception as e:
            log(f"round of versions {nxt}..{nxt + C - 1} failed: {e!r}")
            win.failed += C
            return
        t1 = clock()
        win.units += C
        win.records += sum(run.log.records_of(v) for v in range(nxt, nxt + C))
        nxt += C
        if t1 >= deadline:
            return


def written(run: Run, win: Window) -> int:
    return run.loaded + win.units


def readback(run: Run, win: Window) -> list:
    rb, C, last = run.mix["readback"], int(run.mix["clients"]), \
        written(run, win) - 1
    rng = gen.rng_for(run.seed, 4)
    newest = list(range(max(run.loaded - 1, last - C + 1), last + 1))
    pool = np.arange(run.loaded, newest[0])
    vids = newest + sorted(int(v) for v in rng.choice(
        pool, size=min(int(rb["versions"]), len(pool)), replace=False))
    keys = rng.choice(run.log.n_base, size=int(rb["evolution_keys"]),
                      replace=False)
    return read_every_copy(run, tuple([("version", v) for v in vids]
                                      + [("evolution", int(k))
                                         for k in keys]))


def measure(win: Window) -> Dict[str, float]:
    if win.seconds <= 0:
        return {}
    return {"ingest_records_per_s": win.records / win.seconds}
