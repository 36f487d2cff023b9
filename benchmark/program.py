"""The program under test, as a cell's configuration states it: the preset
the configuration file names, with each of the file's settings put over it,
and the layout and batch of the traffic; and loading the harness's weights.
"""

from __future__ import annotations

# a configuration file's key → the program's config keys it sets
_KEYS = {
    "backbone": ("model.backbone",),
    "embedding_dim": ("model.embedding_dim",),
    "input_size": ("model.input_size", "data.image_size"),
    "dropout": ("model.dropout",),
    "compute_dtype": ("model.compute_dtype",),
    "param_dtype": ("model.param_dtype",),
    "num_classes": ("data.num_classes",),
    "degrade_min": ("data.degrade_min",),
    "degrade_max": ("data.degrade_max",),
    "resize_mode": ("data.resize_mode",),
    "head": ("loss.head",),
    "scale": ("loss.scale",),
    "margin": ("loss.margin",),
    "ce_block": ("loss.ce_block",),
    "ce_streaming_threshold": ("loss.ce_streaming_threshold",),
    "lr": ("train.lr",),
    "momentum": ("train.momentum",),
    "weight_decay": ("train.weight_decay",),
    "warmup_steps": ("train.warmup_steps",),
}


def program_config(cell, seed: int):
    from crfr_torch.configs import get_config

    over = {k: cell.config[name] for name, keys in _KEYS.items() for k in keys}
    data, model = cell.traffic["layout"]
    over.update({"mesh.data": data, "mesh.model": model, "train.seed": seed,
                 "train.batch_size": cell.traffic["batch"], "train.log_every": 10 ** 9})
    return get_config(cell.config["preset"]).override(**over)


def steps_per_epoch(cell) -> int:
    return max(cell.config["images"] // cell.traffic["batch"], 1)


def load_weights(trainer, params: dict, stats: dict) -> None:
    """Put the harness's parameters and BN statistics into ``trainer``
    through its state (on a mesh every rank calls: W is gathered and cut)."""
    st = trainer.state
    for name, value in {**params, **stats}.items():
        if name not in st["model"]:
            raise KeyError(f"the program has no {name!r}")
        st["model"][name] = value
    trainer.state = st
