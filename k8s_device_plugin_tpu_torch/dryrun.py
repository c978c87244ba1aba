"""The twin of the JAX package's entry points (``__graft_entry__.py``)
in PyTorch.

``entry()``             the loss of the smoke transformer on example
                        arguments, on one device.
``dryrun_multichip(n)`` the full sharded train step over a mesh of n ranks
                        for each parallelism plan the port implements:
                        fsdp + tensor, sequence (ring attention), expert
                        (MoE) and pipeline (GPipe), on ``tiny()`` shapes;
                        then a sharded greedy decode, a checkpoint saved
                        on one mesh and restored onto another, and, on
                        the CPU, the multi-process smoke.

    python -m k8s_device_plugin_tpu_torch.dryrun --dryrun-only N [--device cpu]

The n ranks are processes of ``parallel.distributed.RankPool``: gloo ranks
on the CPU, one NCCL rank a card on the card (n cards). Each plan prints
one ``dryrun_multichip(n) <plan>: mesh={...} loss=... OK`` line, and each
later leg its own ``... OK`` line, as the JAX dryrun does.

One departure from the JAX plans: on the card, plan F (flash attention
under fsdp + tp) takes ``tiny()`` at d_model 128, head_dim 64, since the
flash kernels take head_dim 64 or 128 in bf16 only, and ``tiny()``'s
head_dim is 16. Every other plan, and every plan on the CPU, keeps
``tiny()``.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import tempfile

import torch

# The JAX plans' abbreviation of each mesh axis, in mesh order.
_ABBREV = ("dp", "fsdp", "ep", "pp", "sp", "tp")


def entry(device=None):
    """(fn, example_args) with ``fn(*example_args)`` the loss of the default
    ``ModelConfig()`` on a batch of 8, on one device: the card unless the
    caller asks for the CPU."""
    from .workload.model import ModelConfig, init_model
    from .workload.train import loss_fn

    cfg = ModelConfig()
    model = init_model(cfg, 0, device)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len), generator=gen)
    return loss_fn, (model, tokens.to(next(model.parameters()).device))


def _mesh_plans(n: int):
    """The JAX ``_mesh_plans``: mesh shapes (data, fsdp, expert, pipe, seq,
    model) and config tweaks covering every parallelism axis, each named by
    the axes larger than 1. Axes that do not divide n collapse to 1."""
    two = 2 if n % 2 == 0 else 1
    rest = n // two

    def label(shape):
        parts = [a for a, size in zip(_ABBREV, shape) if size > 1]
        return "+".join(parts) if parts else "single"

    seq = 2 if rest % 2 == 0 else 1
    shape_a = (1, rest // seq, 1, 1, seq, two)
    plans = [(label(shape_a), shape_a, {"ring": seq > 1})]
    if seq > 1:
        plans.append((label(shape_a) + ":ring-qchunk", shape_a, {"ring": True, "qchunk": True}))
    if two == 2 and rest % 2 == 0:
        shape_b = (1, rest // 2, 2, 1, 1, two)
        plans.append((label(shape_b), shape_b, {"moe": True}))
        shape_c = (rest // 2, 1, 1, 2, 1, two)
        plans.append((label(shape_c), shape_c, {"pipeline": True}))
    if n % 8 == 0:
        shape_d = (1, n // 4, 2, 1, 2, 1)
        plans.append((label(shape_d), shape_d, {"ring": True, "moe": True}))
    if two == 2:
        shape_e = (1, n // two, 1, 1, 1, two)
        plans.append((label(shape_e) + ":chunked-xent", shape_e, {"xent": True}))
        plans.append((label(shape_e) + ":flash-attn", shape_e, {"flash": True}))
    return plans


def plan_config(opts: dict, on_card: bool = False):
    """The JAX dryrun's config of a plan: ``tiny()`` with its tweaks (on
    the card, plan F at d_model 128)."""
    from .workload.model import ModelConfig

    cfg = ModelConfig.tiny()
    if opts.get("ring"):
        cfg = dataclasses.replace(cfg, use_ring_attention=True)
    if opts.get("qchunk"):
        cfg = dataclasses.replace(cfg, ring_q_chunk=cfg.max_seq_len // 4)
    if opts.get("xent"):
        cfg = dataclasses.replace(cfg, xent_chunk=cfg.vocab_size // 2)
    if opts.get("flash"):
        cfg = dataclasses.replace(cfg, use_flash_attention=True,
                                  d_model=128 if on_card else cfg.d_model)
    if opts.get("moe"):
        cfg = dataclasses.replace(cfg, n_experts=4)
    if opts.get("pipeline"):
        cfg = dataclasses.replace(cfg, n_layers=2, pipeline_microbatches=2)
    return cfg


def plan_step(shape, opts: dict, batch: int, device: str) -> float:
    """One rank's part of a plan: the sharded train step of the plan's
    config on a mesh of ``shape``, weights from seed 0, on the global batch
    of ``batch`` rows from seed 1; returns the global loss."""
    from .parallel.distributed import local_device
    from .parallel.mesh import batch_shard, make_mesh
    from .workload import train
    from .workload.model import init_model

    dev = local_device(device)
    cfg = plan_config(opts, dev.type == "cuda")
    mesh = make_mesh(shape=shape, device=dev)
    model = train.shard_model(init_model(cfg, 0, dev), mesh)
    optimizer = train.make_optimizer(model)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=gen)
    loss = float(train.train_step(model, optimizer, batch_shard(tokens, mesh).to(dev)))
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} on the mesh {shape} with {opts}")
    return loss


# The decode leg's prompt length and new tokens (__graft_entry__.py:247-274).
DECODE_PROMPT = 8
DECODE_STEPS = 4


def decode_step(shape, batch: int, device: str, cfg_kw: dict | None = None,
                state: dict | None = None) -> dict:
    """One rank's part of the decode leg: ``tiny()`` (or ``cfg_kw``) laid
    out on a mesh of ``shape`` as for training (weights from seed 0, or
    ``state``, numpy arrays by name), then ``greedy_generate`` of
    ``DECODE_STEPS`` tokens after the ``DECODE_PROMPT``-token prompt of
    seed 2 (``batch`` rows) on this rank's rows. Raises unless the output
    keeps the prompt and every token is in the vocabulary; returns the
    count of tokens generated, this rank's batch shard and its tokens."""
    from .parallel.distributed import local_device
    from .parallel.mesh import batch_index, batch_shard, make_mesh
    from .workload import train
    from .workload.generate import greedy_generate
    from .workload.model import ModelConfig, init_model

    dev = local_device(device)
    cfg = ModelConfig(**cfg_kw) if cfg_kw else ModelConfig.tiny()
    mesh = make_mesh(shape=shape, device=dev)
    model = init_model(cfg, 0, dev)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    train.shard_model(model, mesh)
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (batch, DECODE_PROMPT), generator=gen)
    rows = batch_shard(prompt, mesh).to(dev)
    tokens = greedy_generate(model, rows, DECODE_STEPS)
    if not (tokens.shape == (len(rows), DECODE_PROMPT + DECODE_STEPS)
            and torch.equal(tokens[:, :DECODE_PROMPT], rows)
            and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())):
        raise RuntimeError(f"decode on the mesh {shape} gave {tokens.tolist()}")
    return {"generated": tokens.shape[1] - DECODE_PROMPT, "batch": batch_index(mesh),
            "tokens": tokens.cpu().numpy()}


def reshard_step(shape_a, shape_b, batch: int, directory: str, device: str) -> float:
    """One rank's part of the checkpoint-reshard leg: one ``tiny()`` step on
    a mesh of ``shape_a`` (weights from seed 0, the batch of seed 3), saved
    as step 1 under ``directory``, restored onto a fresh model on a mesh of
    ``shape_b``, and one step there; returns that step's global loss.
    Raises unless step 1 was restored and the loss is finite."""
    from .parallel.distributed import local_device
    from .parallel.mesh import batch_shard, make_mesh
    from .workload import train
    from .workload.checkpointing import TrainCheckpointer
    from .workload.model import ModelConfig

    dev = local_device(device)
    cfg = ModelConfig.tiny()
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=gen)
    mesh_a = make_mesh(shape=shape_a, device=dev)
    model, optimizer = train.make_train_state(cfg, dev, 0, mesh=mesh_a)
    train.train_step(model, optimizer, batch_shard(tokens, mesh_a).to(dev))
    with TrainCheckpointer(directory, save_every=1) as ckpt:
        ckpt.save(1, model, optimizer)
    del model, optimizer
    mesh_b = make_mesh(shape=shape_b, device=dev)
    model, optimizer = train.make_train_state(cfg, dev, 0, mesh=mesh_b)
    with TrainCheckpointer(directory) as ckpt:
        restored = ckpt.restore_latest(model, optimizer)
    if restored is None or restored[0] != 1:
        raise RuntimeError(f"restored {restored and restored[0]}, expected step 1")
    loss = float(train.train_step(model, optimizer, batch_shard(tokens, mesh_b).to(dev)))
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite post-restore loss {loss}")
    return loss


def dryrun_multichip(n_devices: int, device=None) -> dict[str, float]:
    """The sharded train step of every plan of ``_mesh_plans(n_devices)``
    over n ranks (gloo on the CPU, NCCL on n cards: the card unless the
    caller asks for the CPU), one ``... OK`` line a plan; then, in the JAX
    dryrun's order, the decode leg (greedy decoding on the fsdp x tensor
    mesh), the checkpoint-reshard leg (saved on that mesh, restored onto
    fsdp n) and, on the CPU only, the two-process smoke. Returns each
    plan's loss by name, and the losses of the reshard leg and the
    two-process smoke."""
    from .device import resolve_device
    from .parallel.distributed import RankPool
    from .parallel.mesh import AXES

    dev = resolve_device(device).type
    if dev == "cuda":
        from .ops._build import build_all

        build_all()  # once, before the ranks would each build
    batch = max(2 * n_devices, 4)
    losses = {}
    with RankPool(n_devices, dev) as pool:
        for name, shape, opts in _mesh_plans(n_devices):
            loss = pool.run(plan_step, shape, opts, batch, dev)[0]
            losses[name] = loss
            print(f"dryrun_multichip({n_devices}) {name}: mesh={dict(zip(AXES, shape))} "
                  f"loss={loss:.4f} OK", flush=True)
        two = 2 if n_devices % 2 == 0 else 1
        shape_a = (1, n_devices // two, 1, 1, 1, two)
        generated = pool.run(decode_step, shape_a, batch, dev)[0]["generated"]
        print(f"dryrun_multichip({n_devices}) decode: mesh={dict(zip(AXES, shape_a))} "
              f"generated={generated} tokens OK", flush=True)
        shape_b = (1, n_devices, 1, 1, 1, 1)
        with tempfile.TemporaryDirectory() as directory:
            loss = pool.run(reshard_step, shape_a, shape_b, batch, directory, dev)[0]
        losses["checkpoint-reshard"] = loss
        print(f"dryrun_multichip({n_devices}) checkpoint-reshard: "
              f"{dict(zip(AXES, shape_a))} -> {dict(zip(AXES, shape_b))} loss={loss:.4f} OK",
              flush=True)
    if dev == "cpu":
        losses["multiprocess"] = _dryrun_multiprocess(n_devices)
    return losses


def _dryrun_multiprocess(n_devices: int) -> float:
    """Two localhost "hosts" of n/2 gloo ranks each, one fsdp step whose
    gradient reduction crosses the process boundary
    (``parallel/mp_smoke.py``)."""
    from .parallel import mp_smoke

    local = max(1, n_devices // 2)
    loss = mp_smoke.launch_local(num_processes=2, local_devices=local)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite multiprocess loss {loss}")
    print(f"dryrun_multichip({n_devices}) multiprocess: 2 procs x {local} devices, "
          f"fsdp across processes, loss={loss:.4f} OK", flush=True)
    return loss


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dryrun-only", type=int, metavar="N", default=None,
                   help="run only dryrun_multichip(N)")
    p.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    if args.dryrun_only is not None:
        dryrun_multichip(args.dryrun_only, args.device)
        return 0
    # As the JAX script: the dryrun at 8, on the CPU only when asked.
    if args.device != "cpu" and torch.cuda.device_count() < 8:
        raise SystemExit(
            f"the dryrun at 8 needs 8 cards and {torch.cuda.device_count()} are "
            "visible: pass --device cpu, or --dryrun-only N with N no more than "
            "the visible cards")
    fn, example = entry(args.device)
    print("entry loss:", float(fn(*example)), flush=True)
    dryrun_multichip(8, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
