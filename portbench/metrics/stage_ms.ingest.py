"""Write session: host ms a version spends staged by ``WriteSession.commit``."""
SPANS = {"repro_torch.core.ingest:WriteSession.commit": "stage"}


def read(obs):
    return obs.span_ms("stage")
