"""The one generator of the benchmark's traffic: a training job's batches,
made on the device from the seed, as a traffic file
(``traffic/<name>.json``) describes them:

- ``kind``: the module of ``kinds/`` that drives the program with them
  (``train``: one training step a batch);
- ``batch``: rows a step, each of the configuration's full context;
- ``batches``: distinct batches made and kept on the device, taken in turn
  (the first three are the steps that ``correct`` is decided on);
- ``xent_chunk``: the program's chunked-vocabulary loss over chunks of this
  many rows of the vocabulary, or 0 for the full-logits loss;
- ``optimizer``: the AdamW constants (lr, betas, eps, weight_decay).

Tokens are uniform over the vocabulary, from a generator on the device
whose stream is apart from the weights' (``TOKEN_STREAM``).
"""

from __future__ import annotations

import torch

TOKEN_STREAM = 1 << 40


def batches(traffic: dict, vocab: int, seq: int, seed: int, device) -> torch.Tensor:
    """(batches, batch, seq) int64 tokens, the same for the same seed."""
    if traffic["batches"] < 3:
        raise ValueError("a training traffic needs at least 3 distinct batches")
    gen = torch.Generator(device=device).manual_seed(seed + TOKEN_STREAM)
    return torch.randint(0, vocab, (traffic["batches"], traffic["batch"], seq),
                         generator=gen, device=device)
