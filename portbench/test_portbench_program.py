"""The readers of the program's own spans and counters (``harness/program.py``):
the tracer is on for a traced window only, records each request of the
window whole and nothing after it, and a program without the tracer gives
its readers nothing to read."""
import pytest

from portbench.harness import program, registry, runner
from portbench.harness.observe import Observation
from portbench.test_portbench_cells import SEED, TINY, cell
from repro_torch import trace as ptrace

# the metrics read from the program's own records (the older ones with a
# program_span source are the harness's outside spans)
PROGRAM_READS = {
    "parse_chunk_ms.lookup", "parse_map_ms.lookup", "device_wait_ms.lookup",
    "request_self_ms.lookup", "decoded_per_returned.lookup",
    "parse_chunk_ms.snapshot", "parse_map_ms.snapshot", "inflate_ms.snapshot",
    "device_wait_ms.snapshot", "request_self_ms.snapshot", "delta_ms.snapshot",
    "xor_delta_launches_per_chunk.snapshot", "partition_ms.ingest",
    "chunk_build_ms.ingest", "map_rebuild_ms.ingest", "maps_rebuilt.ingest"}


def program_metrics():
    got = [m for m in registry.load_benchmark()["per_layer"]
           if m["name"] in PROGRAM_READS]
    assert len(got) == len(PROGRAM_READS)
    return got


def test_every_program_reader_turns_the_tracer_on_and_off():
    for m in program_metrics():
        mod = registry.load_reader(m["name"])
        assert mod.LAUNCHES == program.LAUNCHES, m["name"]
        assert mod.COUNTERS.items() >= program.COUNTERS.items(), m["name"]


def test_program_readers_read_nothing_where_the_program_records_nothing(
        monkeypatch):
    """A traced run of a program without its own tracer (an older commit):
    the hooks do nothing, the readers return None, and the run's line leaves
    their metrics out."""
    monkeypatch.setattr(program, "_ptrace", None)
    monkeypatch.setattr(program, "_last", None)
    program._request()
    assert program.WINDOW.end == 0.0
    obs = Observation(units=4, counters={"xor_delta": 8.0})
    for m in program_metrics():
        assert registry.load_reader(m["name"]).read(obs) is None, m


@pytest.mark.parametrize("config,mix,root", [("a2-k1", "lookup", "read.request"),
                                             ("a2-k3", "snapshot", "read.request"),
                                             ("a2-k1", "ingest", "write.stage")])
def test_a_traced_window_records_its_requests_and_nothing_else(config, mix,
                                                               root):
    out = runner.run_cell(cell(config, mix), SEED, 0.2, True, device="cpu",
                          scale=TINY)
    assert out["correct"], out["checks"]
    assert ptrace.ACTIVE is None
    rec = program.last()
    roots = [s for s in rec.spans if s.parent is None]
    requests = {s.request for s in rec.spans}
    if mix == "ingest":
        # a session is one request; the read-back after the window is not
        assert not any(s.name.startswith("read.") for s in rec.spans)
        units = out["attempted"] // cell(config, mix).mix["session_versions"]
    else:
        assert {s.name for s in roots} == {root}
        units = out["attempted"]
    assert len(requests) == units
    assert out["metrics"]["request_self_ms." + mix if mix != "ingest"
                          else "partition_ms.ingest"]["value"] > 0


def test_an_untraced_run_never_turns_the_tracer_on(monkeypatch):
    turned_on = []
    monkeypatch.setattr(ptrace, "enable", lambda: turned_on.append(1))
    out = runner.run_cell(cell("a2-k1", "lookup"), SEED, 0.2, False,
                          device="cpu", scale=TINY)
    assert out["correct"], out["checks"]
    assert turned_on == [] and ptrace.ACTIVE is None
