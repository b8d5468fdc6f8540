"""Federated training of the lightweight SR model.

Counterpart of ``experiments/train_federated.py``, with its flags, its
defaults and its closing JSON line, ``{"rounds", "final_loss"}`` (the
server and client modes print none)::

    python -m nerve_tpu_torch.train_federated --mode simulation
    python -m nerve_tpu_torch.train_federated --mode trainer --num-rounds 2
    python -m nerve_tpu_torch.train_federated --mode server --server-address 127.0.0.1:8080
    python -m nerve_tpu_torch.train_federated --mode client --server-address 127.0.0.1:8080 \\
        --client-id 1
    python -m nerve_tpu_torch.train_federated --device cpu --num-clients 2 --num-rounds 1 \\
        --local-steps 1 --samples-per-client 4

Modes: ``simulation`` (``MeshFederatedSimulation`` on one device: every
client's local SGD on the eval forward with the BatchNorm statistics held
at their initial values, ``differentiable=True``, then FedAvg); ``trainer``
(``FederatedTrainer`` over in-process ``VideoEnhancementClient``s, each
training with live BatchNorm); ``server`` (``start_server`` for external
clients over the socket transport); ``client`` (one external client). The
model is ``LightweightSuperResolution(scale_factor=2)`` in float32, its
parameters from a generator seeded ``--seed``; client c's data is
``utils.data.make_sr_dataset`` at LR 16² → HR 32² from a generator seeded
``seed · 100 + c`` at intensity offset ``(c % 5) · 0.1`` (non-IID). One
device holds every simulated client, so ``--num-clients`` is used as given.
It runs on the card unless ``--device cpu``; a port client or server
interoperates with the JAX package's over the same address.
"""

from __future__ import annotations

import argparse
import json

import torch

from nerve_tpu_torch.continual.params import detached
from nerve_tpu_torch.federated import (
    FederatedTrainer,
    MeshFederatedSimulation,
    VideoEnhancementClient,
    VideoEnhancementStrategy,
    start_server,
    tree_to_arrays,
)
from nerve_tpu_torch.federated.privacy import PrivacyConfig
from nerve_tpu_torch.federated.transport import run_client
from nerve_tpu_torch.models import LightweightSuperResolution
from nerve_tpu_torch.utils import data as data_lib
from nerve_tpu_torch.utils.metrics import mse

LR_SIZE, SCALE = 16, 2


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="nerve_tpu_torch federated training")
    p.add_argument("--mode", choices=["simulation", "trainer", "server", "client"],
                   default="simulation")
    p.add_argument("--num-clients", type=int, default=8)
    p.add_argument("--num-rounds", type=int, default=5)
    p.add_argument("--local-epochs", type=int, default=2)
    p.add_argument("--local-steps", type=int, default=5)
    p.add_argument("--samples-per-client", type=int, default=32)
    p.add_argument("--server-address", default="[::]:8080")
    p.add_argument("--client-id", type=int, default=0)
    p.add_argument("--dp", action="store_true", help="enable differential privacy")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--wait-timeout", type=float, default=120.0,
                   help="server: seconds to wait for its clients")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def client_dataset(client_id: int, n: int, seed: int, lr_size: int = LR_SIZE):
    """Non-IID local data: intensity offset by client_id % 5."""
    g = torch.Generator().manual_seed(seed * 100 + client_id)
    return data_lib.make_sr_dataset(g, n, lr_size=lr_size, scale=SCALE,
                                    content_offset=(client_id % 5) * 0.1)


def make_model(seed: int, device) -> LightweightSuperResolution:
    return LightweightSuperResolution(scale_factor=SCALE, device=device,
                                      generator=torch.Generator().manual_seed(seed))


def frozen_stats_loss(model: LightweightSuperResolution):
    """``loss_fn(params, (lr, hr))``: the mean squared error of the eval
    forward under autograd (the BatchNorm statistics held) with ``params``
    in place of the model's parameters; ``model`` must be in eval mode."""

    def loss_fn(params, batch):
        if model.training:
            raise ValueError("the frozen-statistics loss runs the eval forward: call "
                             "model.eval() first")
        lr, hr = batch
        out = torch.func.functional_call(model, dict(params), (lr,), {"differentiable": True})
        return mse(out, hr)

    return loss_fn


def stacked_client_data(num_clients: int, n: int, seed: int, dev, lr_size: int = LR_SIZE):
    """(lr (C, n, h, w, 3), hr (C, n, 2h, 2w, 3)) on ``dev``."""
    datasets = [client_dataset(c, n, seed, lr_size) for c in range(num_clients)]
    return tuple(torch.stack([torch.from_numpy(d[k]) for d in datasets]).to(dev)
                 for k in ("lr", "hr"))


def run_mesh_simulation(args) -> dict:
    model = make_model(args.seed, args.device).eval()
    dev = next(model.parameters()).device
    lrs, hrs = stacked_client_data(args.num_clients, args.samples_per_client, args.seed, dev)
    loss_fn = frozen_stats_loss(model)
    privacy = PrivacyConfig(noise_multiplier=0.1) if args.dp else None
    sim = MeshFederatedSimulation(loss_fn, detached(dict(model.named_parameters())), (lrs, hrs),
                                  local_steps=args.local_steps, local_lr=1e-3, privacy=privacy,
                                  seed=args.seed)
    loss = float("nan")
    for r in range(args.num_rounds):
        m = sim.run_round()
        with torch.no_grad():
            loss = float(loss_fn(sim.params, (lrs[0], hrs[0])))
        print(f"round {r + 1}: update_norm={m['update_norm']:.6e} client0_loss={loss!r}",
              flush=True)
    return {"rounds": args.num_rounds, "final_loss": loss}


def run_trainer(args) -> dict:
    model = make_model(args.seed, args.device)
    clients = [
        VideoEnhancementClient(
            model, client_dataset(c, args.samples_per_client, args.seed), num_frames=1,
            local_epochs=args.local_epochs, batch_size=8,
            privacy=PrivacyConfig() if args.dp else None, seed=c)
        for c in range(args.num_clients)
    ]
    trainer = FederatedTrainer(clients, clients[0].get_parameters(),
                               VideoEnhancementStrategy(fraction_fit=0.5, min_fit_clients=2))
    trainer.run(args.num_rounds)
    ev = trainer.evaluate_round()
    print(f"final weighted eval: {ev}", flush=True)
    return {"rounds": args.num_rounds, "final_loss": ev.get("loss")}


def run_server(args) -> dict:
    model = make_model(args.seed, args.device)
    start_server(tree_to_arrays(dict(model.named_parameters())), num_rounds=args.num_rounds,
                 address=args.server_address, min_clients=2, wait_timeout=args.wait_timeout)
    return {}


def run_external_client(args) -> dict:
    client = VideoEnhancementClient(
        make_model(args.seed, args.device),
        client_dataset(args.client_id, args.samples_per_client, args.seed), num_frames=1,
        local_epochs=args.local_epochs, batch_size=8, seed=args.client_id)
    run_client(client, args.server_address, f"client-{args.client_id}")
    return {}


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    out = {
        "simulation": run_mesh_simulation,
        "trainer": run_trainer,
        "server": run_server,
        "client": run_external_client,
    }[args.mode](args)
    if out:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
