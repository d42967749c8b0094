"""Writing versions to the system under test, whatever its stack.

The store stack (``stacks/<stack>.py``) builds the deployment from its
configuration.  ``load`` writes versions the way the configuration says:
``online`` through writer sessions, each closed by its group flush;
``offline`` staged through writer sessions without a flush, then one
``build()``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def rstore(T, config: Dict, kvs, device):
    """One ``RStore`` over ``kvs`` with the configuration's store
    settings."""
    st = config["store"]
    return T.RStore(T.RStoreConfig(
        algorithm=st["algorithm"], capacity=int(st["capacity"]),
        k=int(st["k"]), batch_size=int(st["batch_size"]),
        beta=int(st["beta"])), kvs, device=device)


def write_session(rs, versions: Sequence[Tuple[int, Dict[int, bytes], list]],
                  first_vid: int, flush: bool = True) -> None:
    """One writer session over ``versions`` (``(parent, adds, dels)``; a
    parent of -1 is the root), closed at the end (``close()`` returns once
    the group flush is durable)."""
    with rs.writer(flush_on_close=flush) as w:    # an error aborts it
        for i, (parent, adds, dels) in enumerate(versions):
            vid = (w.init_root(adds) if parent < 0
                   else w.commit([parent], adds, dels))
            if vid != first_vid + i:
                raise RuntimeError(f"the store numbered version "
                                   f"{first_vid + i} as {vid}")


def load(rs, config: Dict, versions: List) -> None:
    """The root in one session, then every commit in a second (as the
    store's users load a chain)."""
    mode = config["load"]
    if mode not in ("online", "offline"):
        raise ValueError(f"unknown load mode {mode!r}")
    online = mode == "online"
    write_session(rs, versions[:1], 0, flush=online)
    if len(versions) > 1:
        write_session(rs, versions[1:], 1, flush=online)
    if not online:
        rs.build()


def stored_bytes(kvs) -> int:
    """Bytes the KVS holds, summed over the values a ``scan()`` returns."""
    return sum(len(v) for _, v in kvs.scan())
