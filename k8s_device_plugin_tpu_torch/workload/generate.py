"""Greedy generation, the forward-only (serving) path: the counterpart of
the JAX package's ``workload/generate.py``.

Two decoders with one contract, ``(batch, prompt_len) -> (batch,
prompt_len + steps)`` tokens:

- ``greedy_generate`` runs one full forward per token over a fixed
  ``(batch, max_seq_len)`` buffer (positions past the current one hold
  zeros and cannot reach earlier ones through causal attention) and takes
  the argmax at ``pos - 1``. It works for every attention path: with
  ``use_flash_attention`` it launches the flash forward kernel and no
  backward kernel, and with ``use_pallas_norm`` the RMSNorm kernel.
- ``greedy_generate_kv`` feeds one position per call through the
  decode-mode model and its KV cache (``model.KVCache``): the prompt first
  (prefill), then each argmax back in. The plain dense attention path
  only, as in the JAX reference.

Decoding runs without autograd on the model's device: the KV decoder under
``torch.inference_mode()``, and ``greedy_generate`` under
``torch.no_grad()``, since it also decodes over a model that FSDP2 shards
(the dryrun's decode leg), and FSDP2's all-gather reads version counters,
which inference tensors do not keep. The entry point
``run_generation_smoke`` puts it on the card unless the caller asks for
the CPU. The JAX ``lax.fori_loop``/``lax.scan`` loops become
Python loops: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .model import KVCache, ModelConfig, TransformerLM, init_cache, init_model, unembed


def _logits(model: TransformerLM, tokens: torch.Tensor, cache: KVCache | None = None):
    """Logits whatever the config's ``xent_chunk``: chunked CE is a
    training-loss concern, and decoding needs logits (the JAX generation
    paths strip the option). Over the whole vocabulary where tensor
    parallelism split the embedding (``tied_embedding``)."""
    return unembed(model.hidden_states(tokens, cache)[0], model.tied_embedding())


@torch.no_grad()
def greedy_generate(model: TransformerLM, prompt: torch.Tensor, steps: int) -> torch.Tensor:
    """Append ``steps`` greedy tokens to ``prompt`` (batch, prompt_len).

    Each token runs the forward on the whole (batch, max_seq_len) buffer,
    the f32 tied unembedding over every position included, as the JAX
    loop does, and writes the argmax of the logits at ``pos - 1`` at
    ``pos``."""
    cfg = model.cfg
    batch, prompt_len = prompt.shape
    if prompt_len + steps > cfg.max_seq_len:
        raise ValueError(
            f"prompt {prompt_len} + steps {steps} exceeds max_seq_len {cfg.max_seq_len}"
        )
    buf = torch.zeros(batch, cfg.max_seq_len, dtype=torch.long, device=prompt.device)
    buf[:, :prompt_len] = prompt
    for pos in range(prompt_len, prompt_len + steps):
        buf[:, pos] = _logits(model, buf)[:, pos - 1].argmax(-1)
    return buf[:, : prompt_len + steps]


def kv_decode_supported(cfg: ModelConfig) -> bool:
    """Whether this config has a decode-mode equivalent: the one predicate
    on ModelConfig, so guard and probe cannot drift."""
    return cfg.decode_supported()


def _decode_cfg(cfg: ModelConfig) -> ModelConfig:
    if not kv_decode_supported(cfg):
        raise ValueError(
            "KV decoding supports the plain dense attention path only "
            "(no flash/ring/pipeline/MoE)"
        )
    return dataclasses.replace(cfg, decode=True)


def _decode_model(model: TransformerLM) -> TransformerLM:
    """The decode-mode twin of ``model``: its config with ``decode`` set,
    over the very same parameter tensors (nothing is copied)."""
    twin = TransformerLM(_decode_cfg(model.cfg), device="meta")
    twin.load_state_dict(model.state_dict(keep_vars=True), assign=True)
    return twin


def _one_step(model: TransformerLM):
    """``(cache, tok[b]) -> logits[b, vocab]`` of the decode-mode ``model``:
    one position through the KV cache, which it extends in place. Shared by
    the decode loop and the parity check, so the two cannot drift."""

    def one(cache: KVCache, tok: torch.Tensor) -> torch.Tensor:
        return _logits(model, tok[:, None], cache)[:, 0]

    return one


def _prefill(model: TransformerLM, prompt: torch.Tensor):
    """Feed ``prompt`` one position at a time through the decode-mode twin
    of ``model``: (its step function, the cache, the logits at the last
    prompt position)."""
    dmodel = _decode_model(model)
    one = _one_step(dmodel)
    cache = init_cache(dmodel.cfg, prompt.shape[0], prompt.device)
    for t in range(prompt.shape[1]):
        logits = one(cache, prompt[:, t])
    return one, cache, logits


@torch.inference_mode()
def greedy_generate_kv(model: TransformerLM, prompt: torch.Tensor, steps: int) -> torch.Tensor:
    """KV-cache greedy decoding, with the contract and output of
    ``greedy_generate``: O(seq·d) a token instead of a full forward. The
    prompt is fed one position at a time (prefill); the prediction at its
    last position is the first new token, and ``steps - 1`` more follow."""
    prompt_len = prompt.shape[1]
    if steps <= 0:
        return prompt
    if prompt_len + steps > model.cfg.max_seq_len:
        raise ValueError(
            f"prompt {prompt_len} + steps {steps} exceeds max_seq_len {model.cfg.max_seq_len}"
        )
    one, cache, logits = _prefill(model, prompt)
    tok = logits.argmax(-1)
    generated = [tok]
    for _ in range(steps - 1):
        tok = one(cache, tok).argmax(-1)
        generated.append(tok)
    return torch.cat([prompt, torch.stack(generated, dim=1)], dim=1)


@torch.inference_mode()
def _prefill_logits_diff(model: TransformerLM, prompt: torch.Tensor) -> float:
    """Max |logits_full - logits_kv| at the last prompt position: the direct
    numeric parity check between the two decode paths."""
    full = _logits(model, prompt)[:, -1]
    kv = _prefill(model, prompt)[2]
    return float((full - kv).abs().max())


def _timed(fn, device: torch.device) -> float:
    """Host seconds of ``fn()``, ending in a sync on the card."""
    t0 = time.monotonic()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.monotonic() - t0


def run_generation_smoke(
    cfg: ModelConfig | None = None,
    batch: int = 2,
    prompt_len: int = 8,
    steps: int = 8,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """Generate ``steps`` tokens after a random prompt with a model of
    random weights from ``seed``, on the card unless ``device="cpu"``.

    Where the config has a KV path, both decoders run: each timed call
    follows one warm call and ends in a sync, and ``ok`` is the prefill
    logits' agreement (0.1 in bf16, 1e-2 otherwise), not token equality,
    which argmax ties on near-uniform random logits would make flaky.
    Without a KV path ``ok`` is None, and ``greedy_generate`` runs once."""
    cfg = cfg or ModelConfig.tiny()
    if cfg.xent_chunk > 0:
        # Every path below needs logits: strip the training-loss option once.
        cfg = dataclasses.replace(cfg, xent_chunk=0)
    model = init_model(cfg, seed, device)
    dev = model.embed.device
    gen = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen).to(dev)
    tokens = greedy_generate(model, prompt, steps)

    report = {
        "prompt_shape": list(prompt.shape),
        "output_shape": list(tokens.shape),
        "tokens_in_vocab": bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
        "prompt_preserved": bool(torch.equal(tokens[:, :prompt_len], prompt)),
        "flash_attention": cfg.use_flash_attention,
        # Always present; None means there is no KV path to judge against.
        "ok": None,
    }
    if kv_decode_supported(cfg):
        kv = greedy_generate_kv(model, prompt, steps)
        report["kv_decode_s"] = round(
            _timed(lambda: greedy_generate_kv(model, prompt, steps), dev), 4)
        report["full_decode_s"] = round(
            _timed(lambda: greedy_generate(model, prompt, steps), dev), 4)
        report["kv_tokens_match_full"] = bool(torch.equal(tokens, kv))
        logits_diff = _prefill_logits_diff(model, prompt)
        report["kv_prefill_logits_maxdiff"] = round(logits_diff, 5)
        tol = 0.1 if cfg.dtype == torch.bfloat16 else 1e-2
        report["ok"] = logits_diff < tol
    return report
