"""Device: ms a wave the host blocks in copies of device results to the
host (span ``device.wait``: the ``.cpu()`` of each shard's gather in
``ShardedDeviceKVS.multiget`` and of each kernel's results in
``kernels.ops``)."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    return program.span_ms(obs, "device.wait")
