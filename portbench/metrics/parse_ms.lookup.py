"""Chunk store: host ms a wave spends parsing fetched blobs
(``StoredChunk.from_bytes`` and ``ChunkMap.from_bytes``)."""
SPANS = {"repro_torch.core.chunkstore:StoredChunk.from_bytes": "parse",
         "repro_torch.core.chunkstore:ChunkMap.from_bytes": "parse"}


def read(obs):
    return obs.span_ms("parse")
