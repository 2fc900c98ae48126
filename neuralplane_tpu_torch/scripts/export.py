"""Export a trained actor checkpoint to a serving artifact (counterpart of
neuralplane_tpu/scripts/export.py).

  python -m neuralplane_tpu_torch.scripts.export \
      --checkpoint runs/<stamp>/checkpoints/state_latest.pt \
      --obs-dim 22 --act-dim 4 --out actor.pt2

The artifact is a `torch.export.save` file with the Box actor's parameters
baked in and a symbolic batch dimension: a serving process that imports only
torch loads it with `torch.export.load(path).module()` (or
`neuralplane_tpu_torch.utils.export.load_actor`) and calls
`(obs[b,obs], h[b,L,H], mask[b,1]) -> (action[b,act], h'[b,L,H])` at any b,
on the device it was exported on (`--device`, default the card). The
checkpoint is the port's (`state_*.pt`, `actor_*.pt`) or a JAX package
pickle; the artifact is not readable by the JAX package.
"""
from __future__ import annotations

import argparse


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("neuralplane_tpu_torch.export")
    p.add_argument("--checkpoint", required=True,
                   help="state_*.pt / actor_*.pt of a port run, or a JAX package pickle")
    p.add_argument("--out", required=True, help="artifact output path (.pt2)")
    p.add_argument("--obs-dim", type=int, required=True)
    p.add_argument("--act-dim", type=int, default=4)
    p.add_argument("--hidden-size", default="128 128")
    p.add_argument("--act-hidden-size", default="128 128")
    p.add_argument("--recurrent-hidden-size", type=int, default=128)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)

    from ..algorithms.ppo import PPOPolicy
    from ..algorithms.rl_config import RLConfig
    from ..envs.planning import load_low_level_ckpt
    from ..utils.export import export_actor

    cfg = RLConfig(
        hidden_sizes=tuple(int(x) for x in args.hidden_size.split()),
        act_hidden_sizes=tuple(int(x) for x in args.act_hidden_size.split()),
        recurrent_hidden_size=args.recurrent_hidden_size)
    policy = PPOPolicy(cfg, args.obs_dim, args.act_dim, device=args.device)
    policy.actor.load_state_dict(load_low_level_ckpt(args.checkpoint))

    artifact = export_actor(policy)
    with open(args.out, "wb") as f:
        f.write(artifact)
    print(f"wrote {args.out} ({len(artifact)} bytes, obs={args.obs_dim}, "
          f"act={args.act_dim}, batch=symbolic, device={policy.device})")


if __name__ == "__main__":
    main()
