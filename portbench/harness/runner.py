"""One run of one cell: set-up, warm-up, the measured window, the check.

``run_cell`` takes the device as an argument so that the tests can drive a
whole run on the CPU; ``run.py`` refuses to run anywhere but on the card.

The cell's store stack (``stacks/``) builds the deployment, and its traffic
kind (``kinds/``, see ``context.py``) says which versions the op log holds
and set-up loads, drives the window and reads back what it wrote.  Rates
are taken over the whole window.

After the window: the device's peak memory, the bytes the KVS holds, then
the kind's read-back; then the program's state is freed and the reference
answers every query of the window (and of the read-back) from its own
replay of the op log.
"""
from __future__ import annotations

import gc
from typing import Dict, Optional, Tuple

from . import arith, faults, gen, store
from .context import Run, Window, log
from .observe import Observation
from .registry import Cell
from .spans import Launches, Spans, clock, resolve
from .trace import Profiler, idle_by_host


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
    import repro_torch.serve.engine  # noqa: F401  (reads go through it)

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
    kind = cell.kind

    # ---------------------------------------------------------- set-up
    parents, loaded = kind.plan(config, cell.mix, seconds)
    log_ = gen.make_log(config["data"], int(config["n_base_records"]),
                        parents, seed)
    t_data = clock()
    run = Run(T, config, cell.mix, seed, log_,
              gen.version_dicts(log_, 0, log_.n_versions), loaded,
              None, None, cell.stack, sync, 1 if fault == "stale" else 0)
    t_load = clock()
    run.rs, run.kvs = cell.stack.build(T, config, dev)
    store.load(run.rs, config, run.versions[:loaded])
    sync()
    t_warm = clock()
    kind.prepare(run)
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
        c0 = {n: _counter(s, run.kvs) for n, s in counters.items()}
        with prof.window():
            t_open = prof.t_open
            setup_s = t_open - t_process
            spans.start()
            launches.start()
            kind.window(run, win, seconds)
            spans.stop()
            launches.stop()
        win.seconds = prof.t_close - t_open
        c1 = {n: _counter(s, run.kvs) for n, s in counters.items()}
    finally:
        if planted is not None:
            planted.close()
        spans.close()
        launches.close()
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    tr = prof.read() if trace else None

    # ---------------------------------------------------------- after it
    stored = store.stored_bytes(run.kvs)
    n_written = kind.written(run, win)
    raw = sum(log_.records_of(v) for v in range(n_written)) * log_.record_size
    readback = kind.readback(run, win)
    run.state.clear()                  # the program's state goes
    run.rs = run.kvs = run.versions = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---------------------------------------------------------- the check
    t_check = clock()
    mismatches, checked = _compare(log_, n_written, win.answers + readback)
    log(f"check: {checked} answers against the reference in "
        f"{clock() - t_check:.3f} s; {mismatches} differ")

    measured = {
        "setup_s": setup_s,
        "stored_per_raw": stored / raw,
        **kind.measure(win),
    }
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
                                   f"for a {cell.mix['kind']} mix")
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
