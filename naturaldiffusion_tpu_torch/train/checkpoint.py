"""Checkpoint save and restore with the reference's two-tier layout (port of
``naturaldiffusion_tpu/train/checkpoint.py``; reference
``deps/score_sde_pytorch/run_lib.py:69-77,139-173``, ``utils.py:7-28``).

``<workdir>/checkpoints-meta`` is overwritten for preemption resume and
``<workdir>/checkpoints/checkpoint_<step>`` keeps numbered snapshots, as in
the JAX package.  The card has no orbax, so each checkpoint is a directory
holding ``state.pt`` (``torch.save`` of the state on the host: the names
and shapes once, the parameters, Adam's moments and the EMA each as one
flat tensor, the counts)
and the marker ``_CHECKPOINT_METADATA`` (JSON: the step).  Each file is
written to a temporary name and moved into place with ``os.replace``, the
payload first: a directory with a marker always holds a whole payload,
unless a write was cut between a new directory's payload and its marker
(no marker: not a checkpoint) or the payload was lost after it.

:func:`restore` keeps JAX's contract: no directory, or one without the
marker, warns and returns the template; a marker without its payload (a
partial write) raises.
"""

from __future__ import annotations

import json
import logging
import math
import os

import torch

from .ema import EMA
from .losses import OptState
from .state import TrainState

_MARKER = "_CHECKPOINT_METADATA"
_PAYLOAD = "state.pt"


def _abs(path: str) -> str:
    return os.path.abspath(path)


_PARTS = ("params", "mu", "nu", "ema")


def _parts(state: TrainState):
    o = state.opt_state
    return dict(zip(_PARTS, (list(state.params.values()), o.mu, o.nu,
                             state.ema.shadow)))


def _flat(ts):
    """The tensors ``ts`` (one type and device) as one host tensor: one
    device-to-host copy."""
    return torch.cat([t.detach().reshape(-1) for t in ts]).cpu()


def _payload(state: TrainState) -> dict:
    """What ``state.pt`` holds: the names and shapes once, each part's
    tensors as one flat host tensor, the counts."""
    o, e = state.opt_state, state.ema
    return {"step": int(state.step), "names": list(state.params),
            "shapes": [tuple(p.shape) for p in state.params.values()],
            **{k: _flat(ts) for k, ts in _parts(state).items()},
            "count": int(o.count), "sched_count": int(o.sched_count),
            "num_updates": int(e.num_updates), "decay": float(e.decay),
            "warmup": bool(e.warmup)}


def _unflat(payload: dict, part: str) -> dict:
    flat, shapes = payload[part], payload["shapes"]
    return {n: v.view(sh) for n, v, sh in zip(
        payload["names"], flat.split([math.prod(sh) for sh in shapes]),
        shapes)}


def state_dict(state: TrainState) -> dict:
    """The state's numbers, tensors on the host by name (``params``'s
    names): ``{"step", "params", "opt_state": {"count", "sched_count",
    "mu", "nu"}, "ema": {"shadow", "num_updates", "decay", "warmup"}}``."""
    return _as_state_dict(_payload(state))


def _as_state_dict(payload: dict) -> dict:
    return {"step": payload["step"], "params": _unflat(payload, "params"),
            "opt_state": {"count": payload["count"],
                          "sched_count": payload["sched_count"],
                          "mu": _unflat(payload, "mu"),
                          "nu": _unflat(payload, "nu")},
            "ema": {"shadow": _unflat(payload, "ema"),
                    "num_updates": payload["num_updates"],
                    "decay": payload["decay"], "warmup": payload["warmup"]}}


def load_state_dict(path: str) -> dict:
    """:func:`state_dict` of the checkpoint directory ``path``."""
    return _as_state_dict(torch.load(os.path.join(path, _PAYLOAD),
                                     map_location="cpu", weights_only=True))


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


def _save(path: str, state: TrainState) -> str:
    os.makedirs(path, exist_ok=True)
    payload = _payload(state)
    # torch.save's non-zip format: the zip writer's per-record work cost
    # ~4x the time of writing the state's bytes (1 GB for the CIFAR model)
    _atomic_write(os.path.join(path, _PAYLOAD), lambda p: torch.save(
        payload, p, _use_new_zipfile_serialization=False))

    def marker(p):
        with open(p, "w") as fh:
            json.dump({"step": payload["step"], "format": "torch"}, fh)
    _atomic_write(os.path.join(path, _MARKER), marker)
    return path


def save_meta(workdir: str, state: TrainState) -> None:
    """Overwrite the preemption-resume slot."""
    _save(os.path.join(_abs(workdir), "checkpoints-meta"), state)


def save_snapshot(workdir: str, state: TrainState, step: int) -> str:
    return _save(os.path.join(_abs(workdir), "checkpoints",
                              f"checkpoint_{step}"), state)


@torch.no_grad()
def _load_into(template: TrainState, payload: dict) -> TrainState:
    """Copy a checkpoint's payload into ``template``'s tensors (their
    devices and types), one host-to-device copy a part, in place; raises
    on names or shapes that differ from the state's."""
    names = list(template.params)
    shapes = [tuple(p.shape) for p in template.params.values()]
    if payload["names"] != names or [tuple(s) for s in payload["shapes"]] \
            != shapes:
        diff = sorted(set(payload["names"]) ^ set(names))[:8]
        raise KeyError(f"checkpoint names or shapes differ from the "
                       f"state's: {diff}")
    for part, dst in _parts(template).items():
        if len({(t.dtype, t.device) for t in dst}) > 1:
            for t, v in zip(dst, _unflat(payload, part).values()):
                t.copy_(v)
            continue
        flat = payload[part].to(dst[0].device, dst[0].dtype)
        torch._foreach_copy_(dst, [v.view(t.shape) for v, t in zip(
            flat.split([t.numel() for t in dst]), dst)])
    o, e = template.opt_state, template.ema
    template.step = int(payload["step"])
    template.opt_state = OptState(int(payload["count"]), o.mu, o.nu,
                                  int(payload["sched_count"]))
    template.ema = EMA(e.shadow, float(payload["decay"]),
                       int(payload["num_updates"]), bool(payload["warmup"]))
    return template


def restore(workdir_or_path: str, template: TrainState) -> TrainState:
    """Restore into ``template`` (in place) from a workdir's
    ``checkpoints-meta`` or from a snapshot's path; returns the template
    unchanged, with a warning, where no checkpoint exists (the reference's
    behaviour, ``utils.py:7-19``)."""
    path = _abs(workdir_or_path)
    meta = os.path.join(path, "checkpoints-meta")
    if os.path.isdir(meta):
        path = meta
    if not os.path.isfile(os.path.join(path, _MARKER)):
        logging.warning("No checkpoint found at %s. Returned the same state "
                        "as input", path)
        return template
    payload_path = os.path.join(path, _PAYLOAD)
    if not os.path.isfile(payload_path):
        raise FileNotFoundError(
            f"checkpoint {path} has its marker but no {_PAYLOAD}: a partial "
            f"write")
    return _load_into(template, torch.load(payload_path, map_location="cpu",
                                           weights_only=True))


def latest_snapshot_step(workdir: str) -> int | None:
    d = os.path.join(_abs(workdir), "checkpoints")
    if not os.path.isdir(d):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(d)
             if n.startswith("checkpoint_")]
    return max(steps) if steps else None
