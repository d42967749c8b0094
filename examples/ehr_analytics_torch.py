"""The paper's motivating scenario (Example 1) on the PyTorch port:
collaborating teams of analysts maintain branched versions of an EHR
collection; RStore answers full-version, cohort-range, and patient-history
queries, its device steps on the card.

Run:  python examples/ehr_analytics_torch.py [--device cpu]

It mirrors ``examples/ehr_analytics.py`` and prints the same lines.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np

from repro_torch.core import RStore, RStoreConfig
from repro_torch.device import resolve_device

N_PATIENTS = 400


def ehr(pid: int, **fields) -> bytes:
    base = {"patient": pid, "age": int(30 + pid % 50),
            "labs": {"a1c": 5.4, "ldl": 110}}
    base.update(fields)
    return json.dumps(base).encode()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the store's device steps run "
                    "(default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(42)
    rs = RStore(RStoreConfig(algorithm="bottom_up", capacity=16 * 1024,
                             k=4, batch_size=8), device=dev)

    v_base = rs.init_root({p: ehr(p) for p in range(N_PATIENTS)})

    # Team A: diabetes model scores for the 50-60 cohort (keys 200-299 say)
    team_a = rs.commit([v_base], adds={
        p: ehr(p, diabetes_risk=float(rng.random())) for p in range(200, 300)})
    # Team A iterates
    team_a2 = rs.commit([team_a], adds={
        p: ehr(p, diabetes_risk=float(rng.random()), model="v2")
        for p in range(200, 260)})

    # Team B branches from the same baseline: cardiac cohort
    team_b = rs.commit([v_base], adds={
        p: ehr(p, cardiac_flag=bool(rng.random() < 0.2))
        for p in range(0, 150, 3)})

    # merge both teams' results for a combined study
    combined = rs.commit([team_a2, team_b],
                         adds={999: ehr(999, cohort="combined-study")})

    # --- provenance: which EHR version trained model v2? -------------------
    recs, st = rs.get_version(team_a2)
    print(f"model-v2 training snapshot: {len(recs)} EHRs "
          f"({st.chunks_fetched} chunks, {st.kvs_queries} KVS round-trips)")

    # --- cohort query (Q2): patients 200-259 in the combined version -------
    cohort, st = rs.get_range(combined, 200, 259)
    scored = sum(1 for b in cohort.values() if b"diabetes_risk" in b)
    print(f"combined-study cohort [200,259]: {len(cohort)} records, "
          f"{scored} carry risk scores, span={st.chunks_fetched}")

    # --- patient history (Q3): every version of patient 210 ----------------
    evo, st = rs.get_evolution(210)
    print(f"patient 210 history: {len(evo)} versions "
          f"(origins {[v for v, _ in evo]}), span={st.chunks_fetched}")
    for origin, payload in evo:
        d = json.loads(payload)
        print(f"   v{origin}: model={d.get('model', '-')}, "
              f"risk={d.get('diabetes_risk', '-')}")

    # --- storage: dedupe + sub-chunk compression ----------------------------
    print("storage:", rs.storage_stats())


if __name__ == "__main__":
    main()
