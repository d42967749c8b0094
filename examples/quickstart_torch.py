"""Quickstart on the PyTorch port: RStore as a versioned document store
(the paper's API), its device steps on the card.

Run:  python examples/quickstart_torch.py [--device cpu]

It mirrors ``examples/quickstart.py`` and prints the same lines.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import InMemoryKVS, Q, RStore, RStoreConfig, ShardedKVS
from repro_torch.device import resolve_device


def doc(payload: str) -> bytes:
    """Records are opaque bytes — JSON documents here."""
    return ('{"record": "%s", "blob": "%s"}'
            % (payload, "x" * 64)).encode()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the store's device steps run "
                    "(default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    kvs = ShardedKVS([InMemoryKVS() for _ in range(4)])  # 4-shard backend
    rs = RStore(RStoreConfig(algorithm="bottom_up",   # the paper's best
                             capacity=4096,           # chunk size C
                             k=3,                     # sub-chunk compression
                             batch_size=4),           # online batching (§4)
                kvs=kvs, device=dev)

    # -- write session: stage a wave of commits, flush once ----------------
    # All chunks + maps of the whole session reach the backend as ONE
    # multiput per shard (the group commit).
    with rs.writer() as w:
        v0 = w.init_root({pk: doc(f"patient-{pk}/baseline")
                          for pk in range(50)})
        v1 = w.commit([v0], adds={7: doc("patient-7/updated-labs")})
        v2 = w.commit([v0], adds={50: doc("patient-50/new-enrollee")},
                      dels=[3])
        v3 = w.commit([v1, v2], adds={8: doc("patient-8/merged-analysis")})
    print(f"4-version write session = {kvs.stats.n_put_queries} write round "
          f"trips over {len(kvs.shards)} shards "
          f"({kvs.stats.n_values_put} blobs)")

    # -- session API: plan a wave of queries, execute in ONE round trip ----
    snap = rs.snapshot()                       # immutable read view
    res = snap.execute([
        Q.version(v3),                         # Q1: full version
        Q.record(v3, 7),                       # point lookup
        Q.records(v3, [8, 50]),                # multi-point
        Q.range(v3, 10, 19),                   # Q2: key range
        Q.evolution(7),                        # Q3: record history
    ])
    records = res[0].value
    print(f"version {v3}: {len(records)} records; whole 5-query session = "
          f"{res.batch.kvs_queries} KVS round trip "
          f"({res.batch.chunks_fetched} deduped chunks, "
          f"{res.batch.bytes_fetched} bytes)")
    print("patient 7 at v3:", res[1].value[:40], "...")
    print("patients {8, 50}:", sorted(res[2].value))
    print("range [10, 19]:", sorted(res[3].value))
    print("evolution of patient 7:", [(v, p[:28]) for v, p in res[4].value])

    # -- per-query wrappers (single-query sessions) still work -------------
    rec, stats = rs.get_record(v3, 7)
    print(f"wrapper get_record: {stats.kvs_queries} round trip, "
          f"{stats.chunks_fetched} chunk(s)")

    # -- storage ------------------------------------------------------------
    print("storage:", rs.storage_stats())


if __name__ == "__main__":
    main()
