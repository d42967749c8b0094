"""KVS gather: host ms a wave spends in ``ShardedKVS.multiget`` (the
index_select on each shard's table and the copy to the host)."""
SPANS = {"repro_torch.core.kvs:ShardedKVS.multiget": "gather"}


def read(obs):
    return obs.span_ms("gather")
