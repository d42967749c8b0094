"""Group flush: self ms per version of ``WriteSession.close`` (online
partition, chunk and chunk-map builds), without its multiput."""
SPANS = {"repro_torch.core.ingest:WriteSession.close": "flush",
         "repro_torch.core.kvs:ShardedKVS.multiput": "put"}


def read(obs):
    return obs.span_ms("flush")
