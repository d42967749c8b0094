"""One run of one cell: set-up, warm-up, the measured window, the check.

``run_cell`` takes the device as an argument so that the tests can drive a
whole run on the CPU; ``run.py`` refuses to run anywhere but on the card.

The window is closed loop with one client: the next request goes out when
the last has come back, and the window closes with the first request that
ends after ``seconds``; rates are taken over the whole window.  A read
request is a wave of queries through ``StoreQueryEngine.serve``, timed from
the call to the answers on the host.  An ingest request is one writer
session of the mix's versions, acknowledged when its ``close()`` returns.

After the window: the device's peak memory, the bytes the KVS holds, then
(ingest) the acknowledged versions read back through the read path; then the
program's state is freed and the reference answers every query of the
window (and of the read-back) from its own replay of the op log.
"""
from __future__ import annotations

import gc
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import arith, faults, gen, store
from .observe import Observation
from .registry import Cell
from .spans import Launches, Spans, clock, resolve
from .trace import Profiler, idle_by_host


def log(*a) -> None:
    print("[portbench]", *a, file=sys.stderr, flush=True)


@dataclass
class Window:
    """What the window produced and what it took."""

    attempted: int = 0
    failed: int = 0
    seconds: float = 0.0
    latencies: List[float] = field(default_factory=list)
    records: int = 0             # records returned (reads), acknowledged
    units: int = 0               # requests (reads), versions (ingest)
    answers: List[Tuple[Tuple, list]] = field(default_factory=list)


def _n_records(value) -> int:
    if value is None:
        return 0
    if isinstance(value, (dict, list)):
        return len(value)
    return 1


def _counter(spec: str, kvs) -> float:
    owner_name, _, path = spec.partition(":")
    if owner_name == "kvs":
        obj = kvs
        for part in path.split("."):
            obj = getattr(obj, part)
        return float(obj)
    owner, attr = resolve(spec)
    return float(getattr(owner, attr))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault: Optional[str] = None,
             scale: Optional[Dict] = None,
             t_process: Optional[float] = None) -> Dict:
    """Run ``cell`` once; returns the object of the result line, its
    ``checks`` last.  ``scale`` overrides configuration keys (the tests'
    tiny sizes); ``t_process`` is when the process started."""
    t_process = clock() if t_process is None else t_process
    import torch
    import repro_torch.core as T
    from repro_torch.serve.engine import StoreQueryEngine

    t_start = clock()
    torch.set_num_threads(1)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.set_device(dev)
        from repro_torch.kernels import _build
        _build.library()
    t_gen = clock()
    config = {**cell.config, **(scale or {})}
    mix = cell.mix
    kind = mix["kind"]
    data = config["data"]
    n_base = int(config["n_base_records"])

    # ---------------------------------------------------------- set-up
    if kind == "read":
        log_ = gen.make_chain(data, n_base, int(config["n_versions"]), seed)
        loaded = log_.n_versions
    elif kind == "ingest":
        per_version = max(1, int(n_base * float(data["pct_update"])))
        S = int(mix["session_versions"])
        warm = int(mix["warm_sessions"]) * S
        need = float(mix["headroom_records_per_s"]) * seconds / per_version
        n_window = S * (int(need) // S + 1)
        log_ = gen.make_chain(data, n_base, 1 + warm + n_window, seed)
        loaded = 1 + warm
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    t_data = clock()
    versions = gen.version_dicts(log_, 0, log_.n_versions)
    t_load = clock()
    rs, kvs = store.make_store(T, config, dev)
    store.load(rs, config, versions[:loaded])
    sync()
    t_warm = clock()
    engine = StoreQueryEngine(rs)
    stale = 1 if fault == "stale" else 0

    if kind == "read":
        versions = None                # the load's copies are done with
        n_req = int(mix["requests"])
        requests = gen.read_requests(mix, log_, seed, n_req)
        batches = [gen.to_queries(T.Q, r, stale) for r in requests]
        for r in gen.read_requests(mix, log_, seed, int(mix["warm_requests"]),
                                   stream=3):
            engine.serve(gen.to_queries(T.Q, r))
    sync()
    log(f"set-up: start-up and imports {t_start - t_process:.3f} s, kernels "
        f"{t_gen - t_start:.3f} s, op log {t_data - t_gen:.3f} s, version "
        f"dicts {t_load - t_data:.3f} s, load {t_warm - t_load:.3f} s, "
        f"requests and warm-up {clock() - t_warm:.3f} s")

    # ---------------------------------------------------------- window
    readers = cell.readers if trace else {}
    spans = Spans(keep_timeline=trace and on_card)
    launches = Launches()
    counters: Dict[str, str] = {}
    for name, mod in readers.items():
        for target, label in getattr(mod, "SPANS", {}).items():
            spans.wrap(target, label)
        for target, cost in getattr(mod, "LAUNCHES", {}).items():
            launches.wrap(target, cost)
        counters.update(getattr(mod, "COUNTERS", {}))
    planted = faults.install(fault) if fault else None
    prof = Profiler(torch, on_card and trace)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()                       # set-up's garbage is not the window's
    win = Window()
    try:
        c0 = {n: _counter(s, kvs) for n, s in counters.items()}
        with prof.window():
            t_open = prof.t_open
            setup_s = t_open - t_process
            spans.start()
            launches.start()
            if kind == "read":
                _read_window(win, engine, requests, batches, seconds, sync)
            else:
                _ingest_window(win, rs, versions, loaded, S, seconds, sync,
                               log_)
            spans.stop()
            launches.stop()
        win.seconds = prof.t_close - t_open
        c1 = {n: _counter(s, kvs) for n, s in counters.items()}
    finally:
        if planted is not None:
            planted.close()
        spans.close()
        launches.close()
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    tr = prof.read() if trace else None

    # ---------------------------------------------------------- after it
    stored = store.stored_bytes(kvs)
    written = sum(log_.records_of(v) for v in range(loaded + win.units
                                                    if kind == "ingest"
                                                    else loaded))
    raw = written * log_.record_size
    readback: List[Tuple[Tuple, list]] = []
    if kind == "ingest":
        last = loaded + win.units - 1
        rb = _readback_queries(mix, log_, seed, loaded, last)
        try:
            got = StoreQueryEngine(rs).serve(gen.to_queries(T.Q, rb, stale))
            readback = [(rb, [r.value for r in got])]
        except Exception as e:        # every read-back answer is then wrong
            log(f"the read-back failed: {e!r}")
            readback = [(rb, None)]
        n_ref_versions = last + 1
    else:
        n_ref_versions = log_.n_versions
    del engine, rs, kvs, versions
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---------------------------------------------------------- the check
    t_check = clock()
    mismatches, checked = _compare(log_, n_ref_versions,
                                   win.answers + readback)
    log(f"check: {checked} answers against the reference in "
        f"{clock() - t_check:.3f} s; {mismatches} differ")

    measured = {
        "setup_s": setup_s,
        "stored_per_raw": stored / raw,
    }
    if kind == "read" and win.latencies:
        measured["read_p95_ms"] = 1e3 * arith.nearest_rank(win.latencies, 95)
        measured["read_records_per_s"] = win.records / win.seconds
    if kind == "ingest" and win.seconds > 0:
        measured["ingest_records_per_s"] = win.records / win.seconds
    log(f"window: {win.seconds:.3f} s, {win.units} units, {win.attempted} "
        f"requests ({win.failed} failed), {win.records} records; "
        f"setup {setup_s:.3f} s; stored {stored} B for {raw} B raw")
    if win.latencies:
        lat = sorted(win.latencies)
        log(f"latency ms: median {1e3 * lat[len(lat) // 2]:.3f}, p95 "
            f"{1e3 * arith.nearest_rank(lat, 95):.3f}, max "
            f"{1e3 * lat[-1]:.3f} over {len(lat)} requests")

    out: Dict = {"correct": mismatches == 0 and win.failed == 0
                 and checked > 0,
                 "attempted": win.attempted, "failed": win.failed}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics: Dict[str, Dict] = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] not in measured:
                raise RuntimeError(f"the harness measures no {m['name']!r} "
                                   f"for a {kind} mix")
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    else:
        obs = Observation(units=win.units, spans_s=spans.self_s,
                          span_calls=spans.calls,
                          counters={n: c1[n] - c0[n] for n in c0},
                          launches={t: list(v) for t, v
                                    in launches.costs.items()},
                          trace=tr)
        for name, mod in readers.items():
            v = mod.read(obs)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
            else:
                log(f"metric {name}: nothing to read")
    out["metrics"] = metrics
    out["device"] = _device(torch, on_card, peak, tr)
    if tr is not None and on_card:
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": idle_by_host(tr, spans.timeline)}
    # each number compared, with its limit: at most 0 wrong answers and
    # failed requests, at least 1 answer checked
    out["checks"] = {
        "mismatched_answers": {"value": mismatches, "limit": 0, "is": "max"},
        "failed_requests": {"value": win.failed, "limit": 0, "is": "max"},
        "answers_checked": {"value": checked, "limit": 1, "is": "min"}}
    return out


def _read_window(win: Window, engine, requests, batches, seconds, sync
                 ) -> None:
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


def _ingest_window(win: Window, rs, versions, first, S, seconds, sync,
                   log_) -> None:
    deadline = clock() + seconds
    nxt = first
    while True:
        sess = versions[nxt:nxt + S]
        if len(sess) < S:
            log("the pregenerated versions ran out before the window closed")
            return
        win.attempted += S
        try:
            store.write_session(rs, sess, nxt)
            sync()
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


def _readback_queries(mix: Dict, log_, seed: int, first: int, last: int
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


def _compare(log_, n_versions: int, answers) -> Tuple[int, int]:
    from ..reference import store as ref
    commits = [(c.vid, c.parent, c.keys, c.pids, c.dels)
               for c in log_.commits[:n_versions - 1]]
    rep = ref.Replay((log_.root_keys, log_.root_pids), commits, log_.payloads)
    bad = n = 0
    for request, values in answers:
        if values is None or len(values) != len(request):
            bad += len(request)
            n += len(request)
            continue
        for q, got in zip(request, values):
            n += 1
            if not ref.same(got, q, ref.answer(rep, q), log_.payloads):
                bad += 1
    return bad, n


def _device(torch, on_card: bool, peak: int, tr) -> Dict:
    if on_card:
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "count": 1, "memory_peak_bytes": peak}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 0,
             "memory_peak_bytes": 0}
    if tr is not None:
        d["busy_s"] = tr.busy_s
        d["window_s"] = tr.window_s
    return d
