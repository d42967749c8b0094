"""Planner: host ms a wave spends in ``Snapshot.plan_batch`` (``core/plan.py``),
with its one ``ops.bitmap_vm_batch`` call."""
SPANS = {"repro_torch.core.api:Snapshot.plan_batch": "plan"}


def read(obs):
    return obs.span_ms("plan")
