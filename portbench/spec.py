"""Where a cell's pieces live, found by the names in ``BENCHMARK.json``.

====================================  ========================================
``configs/<config>.json``             the model as it is run, its source, the
                                      precision, the weight draw, the cuts,
                                      where it departs from the source
``traffic/<traffic>.json``            the traffic's parameters and the driver
                                      that serves it
``workloads/<cell>.json``             the check's sample and limits
``drivers/<driver>.py``               the code that drives the window
``metrics/<metric>.py``               one reader per per-layer metric
``reference/<arch_type>.py``          the plain float32 forward pass
====================================  ========================================

A later cell or metric is a set of new files and new entries in
``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
# keys of a configuration file that describe it rather than set a field of
# the port's ``ModelConfig``
DESCRIPTIVE = {"name", "port_config", "source", "paper", "precision",
               "reduced", "departs", "assumed", "notes",
               "moe_group_tokens", "padded_vocab", "context_length"}
# Granite-style multipliers the port's model does not have: the file may
# state them only at the value the port's equations amount to
NEUTRAL = {"embedding_multiplier": lambda cfg: 1.0,
           "attention_multiplier": lambda cfg: cfg.hd ** -0.5,
           "residual_multiplier": lambda cfg: 1.0,
           "logits_scaling": lambda cfg: 1.0}


def load_json(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return load_json(pathlib.Path(root) / "BENCHMARK.json")


def find(kind: str, name: str, dirs, suffix: str) -> pathlib.Path:
    """The file ``<dir>/<kind>/<name><suffix>`` of the first dir that
    has it."""
    for d in dirs:
        path = pathlib.Path(d) / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind} named {name!r} under "
                            f"{[str(d) for d in dirs]}")


def load_module(path: pathlib.Path):
    """Import a file by its path (a metric's name may hold dots)."""
    mod_name = "portbench_" + "_".join(
        "".join(c if c.isalnum() else "_" for c in part)
        for part in path.parts[-2:])
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                  # configs/<config>.json
    traffic: dict                 # traffic/<traffic>.json
    workload: dict                # workloads/<cell>.json
    end_to_end: list              # BENCHMARK.json metrics this cell reports
    per_layer: list
    dirs: tuple

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")

    def reference(self):
        return importlib.import_module(
            f"portbench.reference.{self.config['arch_type']}")

    def reader(self, metric: str):
        return load_module(find("metrics", metric, self.dirs, ".py"))


def cell_metrics(bench: dict, name: str):
    """(end-to-end, per-layer) metric entries of cell ``name``: an
    end-to-end metric without ``workloads`` is every cell's; a per-layer
    metric without ``workloads`` is every cell's that reports the
    end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def cell(bench: dict, name: str, dirs=(PKG,)) -> Cell:
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no cell named {name!r}")
    w = entries[0]
    e2e, per = cell_metrics(bench, name)
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(find("configs", w["config"], dirs, ".json")),
                traffic=load_json(find("traffic", w["traffic"], dirs,
                                       ".json")),
                workload=load_json(find("workloads", name, dirs, ".json")),
                end_to_end=e2e, per_layer=per, dirs=tuple(dirs))


def port_config(config: dict):
    """The port's ``ModelConfig`` as the configuration file states it:
    the registered config named ``port_config`` with every field the
    file sets.  Raises on a key that is neither a field nor one of the
    descriptive keys, so the file cannot say what is not run."""
    from repro_torch import configs

    base = configs.get_config(config["port_config"])
    fields = {f.name for f in dataclasses.fields(base)}
    unknown = set(config) - fields - DESCRIPTIVE - set(NEUTRAL)
    if unknown:
        raise KeyError(f"configuration {config['name']}: keys {sorted(unknown)}"
                       f" are not fields of the port's ModelConfig")
    cfg = dataclasses.replace(base, **{k: v for k, v in config.items()
                                       if k in fields and k != "name"})
    for key, value in NEUTRAL.items():
        if key in config and config[key] != value(cfg):
            raise ValueError(f"{config['name']}: the port runs {key} "
                             f"{value(cfg)}, the file says {config[key]}")
    if "moe_group_tokens" in config:
        from repro_torch.models import moe

        if moe.GROUP_SIZE != config["moe_group_tokens"]:
            raise ValueError(f"{config['name']}: the port routes groups of "
                             f"{moe.GROUP_SIZE} tokens, the file says "
                             f"{config['moe_group_tokens']}")
    if "padded_vocab" in config and cfg.padded_vocab != config["padded_vocab"]:
        raise ValueError(f"{config['name']}: the port pads the vocabulary to "
                         f"{cfg.padded_vocab}, the file says "
                         f"{config['padded_vocab']}")
    return cfg
