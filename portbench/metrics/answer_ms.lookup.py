"""Answer: self ms a wave spends in ``plan.answer``, without the payload
decode it calls."""
SPANS = {"repro_torch.core.plan:answer": "answer",
         "repro_torch.core.chunkstore:StoredChunk.payloads": "decode"}


def read(obs):
    return obs.span_ms("answer")
