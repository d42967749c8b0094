"""KVS: host ms per version in ``ShardedKVS.multiput`` (the group commit's
write to every shard's table)."""
SPANS = {"repro_torch.core.kvs:ShardedKVS.multiput": "put"}


def read(obs):
    return obs.span_ms("put")
