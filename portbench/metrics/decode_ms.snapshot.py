"""Chunk store: host ms a request spends in ``StoredChunk.payloads``
(decompression and, at k>1, the delta decode with its xor_delta launches)."""
SPANS = {"repro_torch.core.chunkstore:StoredChunk.payloads": "decode"}


def read(obs):
    return obs.span_ms("decode")
