"""Configuration system.

Capability parity with the reference config layer (ref: utils/config.py):
the same dataclass tree / field names, upper-case YAML sections with
``BASE_CONFIG`` inheritance, the same CLI surface, and Dassl-style dotted
``OPTS`` overrides (``TRAINER.ADAPTER.USE_GP True``).  The implementation is
table-driven rather than a chain of special cases.

The resolved config is what gets dumped into each run's ``metrics.json``
(``config`` key), so field names are part of the output-schema contract.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple


@dataclass
class AdapterConfig:
    """Method-specific knobs shared by all six adaptation methods.

    Field names match the reference AdapterConfig (ref: utils/config.py:13-67)
    because they are addressable from YAML/OPTS and serialized to metrics.json.
    """

    # Template bank
    use_custom_templates: bool = False
    num_templates: int = 1
    l2_lambda: float = 0.1
    template_tw_l2_lambda: float = 0.0
    template_init_method: str = "uniform"  # uniform | val_weighted | top3 | minmax
    train_template_weights: bool = True
    use_linear_template_weighting: bool = False
    freeze_visual_proj: bool = False
    finetune_on_test: bool = False
    shared_template_weights: bool = False

    # score template weights on the FULL train split instead of the few-shot
    # subset (latent OPTS-only key in the reference — ref: trainers/adapter.py:71)
    prefit_on_full_set: bool = False

    # GP template weighter
    use_gp: bool = False
    gp_kernel_type: str = "rbf"  # rbf | linear | matern
    gp_use_elbo: bool = False
    gp_lr: float = 0.001
    gp_beta: float = 0.001
    gp_num_mc_samples_train: int = 30
    gp_num_mc_samples_eval: int = 100
    learn_token_lambda: float = 1e-2
    gp_pca_dim: int = 256
    gp_prior_temp: float = 1.0
    # gpytorch adds settings.variational_cholesky_jitter ("auto" → 1e-4 for
    # float32) to K_zz inside VariationalStrategy, so 1e-4 is the numerics
    # the reference actually runs with (ref: trainers/gp_template_weigher.py
    # delegating to gpytorch.variational.VariationalStrategy).
    gp_jitter: float = 1e-4

    # CLIP-Adapter
    clip_adapter_reduction: int = 4
    clip_adapter_ratio: float = 0.2
    clip_adapter_use_template_weight_training: bool = False
    clip_adapter_optimizer: str = "adam"
    clip_adapter_lr: float = 0.001
    clip_adapter_epochs: int = 100

    # Prompt learning (CoOp / CoCoOp)
    n_ctx: int = 16
    ctx_init: str = ""
    csc: bool = False

    # Tip-Adapter
    tip_adapter_trainable: bool = False
    tip_adapter_use_template_weight_training: bool = False
    tip_adapter_optimizer: str = "sgd"
    tip_adapter_lr: float = 0.001
    tip_adapter_epochs: int = 20
    tip_adapter_init_alpha: float = 0.0
    tip_adapter_init_beta: float = 0.0
    tip_adapter_eps: float = 0.0

    # TaskRes
    taskres_residual_scale: float = 0.5
    taskres_optimizer: str = "adam"
    taskres_lr: float = 0.001
    taskres_epochs: int = 100
    taskres_use_template_weight_training: bool = False


@dataclass
class ModelConfig:
    backbone_name: str = "RN50"
    init_weights: str = ""  # path to converted CLIP weights (.npz); "" = auto-discover
    # opt-in int8 MXU inference for the frozen ViT image tower (serving /
    # feature extraction only — models/quantized.py; no reference analog).
    # Parity guarantees (BASELINE.md) are stated for the default bf16 path.
    int8_inference: bool = False


@dataclass
class DatasetConfig:
    name: str = "Caltech101"
    root: str = "/mnt/features/VDATA"
    num_shots: int = 1
    subsample_classes: str = "all"  # all | base | new
    source_domains: Optional[List[str]] = None
    target_domains: Optional[List[str]] = None
    full_finetune: bool = False


@dataclass
class DataLoaderConfig:
    batch_size_train: int = 128
    batch_size_test: int = 128
    num_workers: int = 8
    drop_last: bool = False


@dataclass
class InputConfig:
    size: Tuple[int, int] = (224, 224)
    interpolation: str = "bicubic"
    pixel_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    pixel_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
    transforms: List[str] = field(
        default_factory=lambda: ["random_resized_crop", "random_flip", "normalize"]
    )


@dataclass
class OptimConfig:
    name: str = "sgd"  # sgd | adam | adamw | muon
    lr: float = 0.01
    max_epoch: int = 300
    lr_scheduler: str = "cosine"
    # scheduler-family knobs — a QUIRK FIX. The reference's scheduler
    # builder reads these via getattr defaults (ref: utils/optimization.py:
    # 232-276), but its config merge hasattr-guards every OPTIM.* key on
    # BOTH the YAML path (ref: utils/config.py:239-241) and the OPTS path
    # (ref: utils/config.py:520-522) and OptimConfig lacks the fields — so
    # the executed reference silently DROPS a configured ETA_MIN/GAMMA/...
    # and always runs with the derived defaults. Here they are typed fields
    # that are honored (documented divergence, COMPONENTS.md); ``None``
    # means "use the reference's derived default" (step_size: max_epoch//3,
    # gamma: 0.1 step/multistep or 0.95 exponential, milestones:
    # [E//2, 3E//4], total_iters: max_epoch)
    eta_min: float = 0.0  # cosine floor
    step_size: Optional[int] = None
    gamma: Optional[float] = None
    milestones: Optional[List[int]] = None
    start_factor: float = 1.0  # linear
    end_factor: float = 0.0  # linear
    total_iters: Optional[int] = None  # linear
    warmup_epoch: int = 1
    warmup_type: str = "constant"  # constant | linear
    warmup_cons_lr: float = 1e-5
    weight_decay: float = 0.0
    momentum: float = 0.9
    betas: Tuple[float, float] = (0.9, 0.999)


@dataclass
class TrainConfig:
    print_freq: int = 5
    eval_freq: int = 1
    checkpoint_freq: int = 0
    enable_tensorboard: bool = False
    enable_adapter_checkpoints: bool = False


@dataclass
class Config:
    trainer_name: str = "Adapter"
    adapter: AdapterConfig = field(default_factory=AdapterConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    input: InputConfig = field(default_factory=InputConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    output_dir: str = "output/default_experiment"
    resume: str = ""
    seed: int = 1
    use_cuda: bool = True  # kept for CLI/schema parity; core/device.py picks the device
    verbose: bool = True

    eval_only: bool = False
    model_dir: str = ""
    load_epoch: Optional[int] = None
    no_train: bool = False
    no_test: bool = False
    final_model: str = "last"  # last | best_val

    # the reference setattr's these onto the config when the CLI flags are
    # given (ref: utils/config.py:441-444), so its metrics.json config block
    # carries them; config_to_dict mirrors the presence semantics (key
    # omitted when never set)
    config_file: Optional[str] = None
    dataset_config_file: Optional[str] = None


# Section-name → sub-config attribute for YAML/OPTS addressing.
_SECTIONS = {
    "adapter": "adapter",
    "model": "model",
    "dataset": "dataset",
    "dataloader": "dataloader",
    "input": "input",
    "optim": "optim",
    "train": "train",
}

_TUPLE_FIELDS = {"size", "pixel_mean", "pixel_std", "betas"}


def _coerce(obj, key: str, value):
    """Coerce YAML/CLI values to the field's expected shape."""
    if key in _TUPLE_FIELDS:
        if isinstance(value, (list, tuple)):
            return tuple(value)
        if isinstance(value, str) and value.startswith("(") and value.endswith(")"):
            return tuple(
                type(getattr(obj, key)[0])(v.strip()) for v in value[1:-1].split(",")
            )
    # quoted YAML booleans ("false") must not land as truthy strings on a
    # bool field
    if isinstance(getattr(obj, key, None), bool) and isinstance(value, str):
        return value.strip().lower() == "true"
    return value


def _warn_unknown_key(obj, dotted_key: str) -> None:
    """Shared unknown-key warning for YAML sections and dotted OPTS — the
    reference silently dropped both (ref: utils/config.py:492-522), which
    made typos invisible."""
    import difflib

    known = (
        [f.name for f in dataclasses.fields(obj)]
        if dataclasses.is_dataclass(obj)
        else [a for a in vars(obj) if not a.startswith("_")]
    )
    leaf = dotted_key.rsplit(".", 1)[-1].lower()
    close = difflib.get_close_matches(leaf, known, n=3)
    hint = f" (did you mean: {', '.join(close)}?)" if close else ""
    print(f"[WARN] unknown config key {dotted_key!r} ignored{hint}")


def _merge_section(section_obj, section_dict: dict, path: str = "") -> None:
    for k, v in section_dict.items():
        lk = k.lower()
        if hasattr(section_obj, lk):
            setattr(section_obj, lk, _coerce(section_obj, lk, v))
        else:
            _warn_unknown_key(section_obj, f"{path}.{k}" if path else k)


def merge_config_dict(config: Config, config_dict: dict) -> None:
    """Merge an upper-case YAML dict into the config tree.

    Handles the reference's nested spellings (ref: utils/config.py:203-263):
    ``TRAINER.ADAPTER.*``, ``DATALOADER.TRAIN_X/TEST.BATCH_SIZE``,
    ``MODEL.BACKBONE.NAME``, string ``DATASET:`` shorthand.
    """
    for key, value in config_dict.items():
        lk = key.lower()
        if lk == "dataset" and isinstance(value, str):
            config.dataset.name = value
            continue
        if key == "TRAINER" and isinstance(value, dict):
            if "ADAPTER" in value:
                _merge_section(config.adapter, value["ADAPTER"],
                               path="TRAINER.ADAPTER")
            if "NAME" in value:
                config.trainer_name = value["NAME"]
            for k in value:
                if k not in ("ADAPTER", "NAME"):
                    _warn_unknown_key(config.adapter, f"TRAINER.{k}")
            continue
        if key == "DATALOADER" and isinstance(value, dict):
            for sub, field in (("TRAIN_X", "batch_size_train"),
                               ("TEST", "batch_size_test")):
                if sub in value and isinstance(value[sub], dict):
                    if "BATCH_SIZE" in value[sub]:
                        setattr(config.dataloader, field,
                                value[sub]["BATCH_SIZE"])
                    for k in value[sub]:
                        if k != "BATCH_SIZE":
                            _warn_unknown_key(
                                config.dataloader, f"DATALOADER.{sub}.{k}")
            _merge_section(
                config.dataloader,
                {k: v for k, v in value.items() if k not in ("TRAIN_X", "TEST")},
                path="DATALOADER",
            )
            continue
        if key == "MODEL" and isinstance(value, dict):
            if "BACKBONE" in value and isinstance(value["BACKBONE"], dict):
                if "NAME" in value["BACKBONE"]:
                    config.model.backbone_name = value["BACKBONE"]["NAME"]
                for k in value["BACKBONE"]:
                    if k != "NAME":
                        _warn_unknown_key(config.model, f"MODEL.BACKBONE.{k}")
            # flat spellings (BACKBONE_NAME, INIT_WEIGHTS, INT8_INFERENCE)
            # merge like any section; unknown keys warn instead of vanishing
            _merge_section(
                config.model,
                {k: v for k, v in value.items() if k != "BACKBONE"},
                path="MODEL",
            )
            continue
        if lk in _SECTIONS and isinstance(value, dict):
            _merge_section(getattr(config, _SECTIONS[lk]), value, path=key)
            continue
        if hasattr(config, lk):
            attr = getattr(config, lk)
            if isinstance(value, dict) and dataclasses.is_dataclass(attr):
                _merge_section(attr, value)
            else:
                setattr(config, lk, value)


def merge_config_from_file(config: Config, config_file: str) -> None:
    """Merge a YAML file, resolving ``BASE_CONFIG`` inheritance first.

    Base paths resolve relative to the referencing file, falling back to the
    working directory (ref: utils/config.py:165-200).
    """
    if not config_file:
        return
    path = Path(config_file)
    if not path.exists():
        return
    import yaml  # only the --config-file path needs PyYAML

    with path.open() as f:
        file_config = yaml.safe_load(f) or {}
    base = file_config.pop("BASE_CONFIG", None)
    if base:
        base_path = Path(base)
        if not base_path.is_absolute():
            cand = path.parent / base_path
            base_path = cand if cand.exists() else (Path.cwd() / base)
        merge_config_from_file(config, str(base_path))
    merge_config_dict(config, file_config)


def _parse_opt_value(value: str):
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    if value.startswith("["):
        # list literals (e.g. OPTIM.MILESTONES "[10, 20]") — the reference's
        # OPTS parser leaves these as strings (ref: utils/config.py:480-486),
        # which its schedulers then crash on; documented fix
        import ast

        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            if value.endswith("]"):
                # bare identifiers (INPUT.TRANSFORMS "[normalize, random_flip]")
                # are not python literals; split them as strings rather than
                # silently leaving a bracketed string on a List[str] field
                inner = value[1:-1].strip()
                return (
                    [v.strip().strip("'\"") for v in inner.split(",")]
                    if inner
                    else []
                )
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def set_nested(config: Config, dotted_key: str, value) -> None:
    """Apply a dotted override like ``TRAINER.ADAPTER.USE_GP``.

    Unknown leaves warn with near-miss suggestions instead of failing — the
    reference silently dropped them (ref: utils/config.py:492-522), which
    made typos invisible."""
    parts = [p.lower() for p in dotted_key.split(".")]
    obj = config
    for part in parts[:-1]:
        if part == "trainer" and len(parts) > 2:
            continue  # TRAINER.ADAPTER.X addresses config.adapter.x
        if part in _SECTIONS:
            obj = getattr(config, _SECTIONS[part])
        elif hasattr(obj, part):
            obj = getattr(obj, part)
    leaf = parts[-1]
    if hasattr(obj, leaf):
        setattr(obj, leaf, _coerce(obj, leaf, value))
    else:
        _warn_unknown_key(obj, dotted_key)


def merge_from_opts(config: Config, opts: List[str]) -> None:
    if len(opts) % 2 != 0:
        raise ValueError(f"OPTS must be key/value pairs, got odd length: {opts}")
    for i in range(0, len(opts), 2):
        set_nested(config, opts[i], _parse_opt_value(opts[i + 1]))


DATASET_CHOICES = [
    "Caltech101", "OxfordPets", "OxfordFlowers", "FGVCAircraft",
    "DescribableTextures", "EuroSAT", "StanfordCars", "Food101",
    "SUN397", "UCF101", "ImageNet", "ImageNetSketch", "ImageNetV2",
    "ImageNetA", "ImageNetR", "Synthetic",
]

BACKBONE_CHOICES = [
    "RN50", "RN101", "RN50x4", "RN50x16", "ViT-B/32", "ViT-B/16", "ViT-L/14@336px",
    # tiny random-weight towers for tests/smoke runs
    "TEST-ViT", "TEST-RN",
]

# The reference CLI offers both its registered trainer names and a set of
# legacy aliases (ref: utils/config.py:282 vs utils/trainer_registry use); we
# accept both and normalize via TRAINER_ALIASES at build time.
TRAINER_CHOICES = [
    "Adapter", "Adapter-CoOp", "Adapter-CoCoOp", "CLIP-Adapter", "TaskRes",
    "Tip-Adapter", "Adapter-TipA", "Adapter-TipA-F", "Adapter-CLIP-Adapter",
]

TRAINER_ALIASES = {
    "Adapter-TipA": "Tip-Adapter",
    "Adapter-TipA-F": "Tip-Adapter-F",
    "Adapter-CLIP-Adapter": "CLIP-Adapter",
}


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI surface parity with the reference (ref: utils/config.py:266-341)."""
    p = argparse.ArgumentParser(description="clip_gp_tpu_torch training")
    p.add_argument("--root", type=str, default=None)
    p.add_argument("--dataset", type=str, default=None, choices=DATASET_CHOICES)
    p.add_argument("--shots", type=int, default=None)
    p.add_argument("--backbone", type=str, default=None, choices=BACKBONE_CHOICES)
    p.add_argument("--trainer", type=str, default=None, choices=TRAINER_CHOICES)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--optimizer", type=str, default=None,
                   choices=["sgd", "adam", "adamw", "muon"])
    p.add_argument("--num-templates", type=int, default=None)
    p.add_argument("--l2-lambda", type=float, default=None)
    p.add_argument("--template-tw-l2-lambda", type=float, default=None)
    p.add_argument("--template-init-method", type=str, default=None,
                   choices=["uniform", "val_weighted", "top3", "minmax"])
    p.add_argument("--train-template-weights", action="store_true")
    p.add_argument("--use-linear-template-weighting", action="store_true")
    p.add_argument("--freeze-visual-proj", action="store_true")
    p.add_argument("--finetune-on-test", action="store_true")
    p.add_argument("--shared-template-weights", action="store_true")
    p.add_argument("--use-gp", action="store_true")
    p.add_argument("--gp-kernel-type", type=str, default=None,
                   choices=["rbf", "linear", "matern"])
    p.add_argument("--gp-use-elbo", action="store_true")
    p.add_argument("--gp-lr", type=float, default=None)
    p.add_argument("--gp-beta", type=float, default=None)
    p.add_argument("--gp-num-mc-samples-train", type=int, default=None)
    p.add_argument("--gp-num-mc-samples-eval", type=int, default=None)
    p.add_argument("--learn-token-lambda", type=float, default=None)
    p.add_argument("--gp-pca-dim", type=int, default=None)
    p.add_argument("--n-ctx", type=int, default=None)
    p.add_argument("--ctx-init", type=str, default=None)
    p.add_argument("--csc", action="store_true")
    p.add_argument("--clip-adapter-reduction", type=int, default=None)
    p.add_argument("--clip-adapter-ratio", type=float, default=None)
    p.add_argument("--output-dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--config-file", type=str, default="")
    p.add_argument("--dataset-config-file", type=str, default="")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--model-dir", type=str, default="")
    p.add_argument("--load-epoch", type=int)
    p.add_argument("--no-train", action="store_true")
    p.add_argument("--source-domains", type=str, nargs="+")
    p.add_argument("--target-domains", type=str, nargs="+")
    p.add_argument("--transforms", type=str, nargs="+")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p


# (CLI flag dest) → (config path) for simple value flags.
_ARG_MAP = {
    "root": "dataset.root",
    "dataset": "dataset.name",
    "shots": "dataset.num_shots",
    "backbone": "model.backbone_name",
    "trainer": "trainer_name",
    "lr": "optim.lr",
    "epochs": "optim.max_epoch",
    "optimizer": "optim.name",
    "num_templates": "adapter.num_templates",
    "l2_lambda": "adapter.l2_lambda",
    "template_tw_l2_lambda": "adapter.template_tw_l2_lambda",
    "template_init_method": "adapter.template_init_method",
    "gp_kernel_type": "adapter.gp_kernel_type",
    "gp_lr": "adapter.gp_lr",
    "gp_beta": "adapter.gp_beta",
    "gp_num_mc_samples_train": "adapter.gp_num_mc_samples_train",
    "gp_num_mc_samples_eval": "adapter.gp_num_mc_samples_eval",
    "learn_token_lambda": "adapter.learn_token_lambda",
    "gp_pca_dim": "adapter.gp_pca_dim",
    "n_ctx": "adapter.n_ctx",
    "ctx_init": "adapter.ctx_init",
    "clip_adapter_reduction": "adapter.clip_adapter_reduction",
    "clip_adapter_ratio": "adapter.clip_adapter_ratio",
    "output_dir": "output_dir",
    "seed": "seed",
    "resume": "resume",
    "load_epoch": "load_epoch",
    "source_domains": "dataset.source_domains",
    "target_domains": "dataset.target_domains",
    "transforms": "input.transforms",
}

# store_true flags → config path (set only when present).
_FLAG_MAP = {
    "train_template_weights": "adapter.train_template_weights",
    "use_linear_template_weighting": "adapter.use_linear_template_weighting",
    "freeze_visual_proj": "adapter.freeze_visual_proj",
    "finetune_on_test": "adapter.finetune_on_test",
    "shared_template_weights": "adapter.shared_template_weights",
    "use_gp": "adapter.use_gp",
    "gp_use_elbo": "adapter.gp_use_elbo",
    "csc": "adapter.csc",
    "eval_only": "eval_only",
    "no_train": "no_train",
}


def parse_args_to_config(argv: Optional[List[str]] = None) -> Config:
    """Resolve the full config: defaults ← dataset YAML ← trainer YAML ← CLI ← OPTS."""
    args = build_arg_parser().parse_args(argv)
    config = Config()
    if args.dataset_config_file:
        merge_config_from_file(config, args.dataset_config_file)
        config.dataset_config_file = args.dataset_config_file
    if args.config_file:
        merge_config_from_file(config, args.config_file)
        config.config_file = args.config_file
    for dest, path in _ARG_MAP.items():
        value = getattr(args, dest, None)
        if value is not None:
            set_nested(config, path, value)
    for dest, path in _FLAG_MAP.items():
        if getattr(args, dest, False):
            set_nested(config, path, True)
    if args.batch_size is not None:
        config.dataloader.batch_size_train = args.batch_size
        config.dataloader.batch_size_test = args.batch_size
    if args.model_dir:
        config.model_dir = args.model_dir
    if args.opts:
        merge_from_opts(config, args.opts)
    return config


def config_to_dict(config) -> dict:
    if dataclasses.is_dataclass(config):
        return {
            f.name: config_to_dict(getattr(config, f.name))
            for f in dataclasses.fields(config)
            # reference presence semantics: the file-path keys exist on its
            # config object only when the CLI flags were passed
            if not (
                f.name in ("config_file", "dataset_config_file")
                and getattr(config, f.name) is None
            )
        }
    if isinstance(config, tuple):
        return list(config)
    return config


def config_from_dict(d: dict, config=None) -> "Config":
    """Inverse of ``config_to_dict`` — rebuild a Config from a saved
    config.json (the predict/serving entry reloads a run's exact
    configuration from its output directory). Unknown keys are ignored so
    configs written by newer versions still load."""
    if config is None:
        config = Config()
    for f in dataclasses.fields(config):
        if f.name not in d:
            continue
        v = d[f.name]
        cur = getattr(config, f.name)
        if dataclasses.is_dataclass(cur):
            if isinstance(v, dict):
                config_from_dict(v, cur)
        elif isinstance(cur, tuple) and isinstance(v, list):
            setattr(config, f.name, tuple(v))
        else:
            setattr(config, f.name, v)
    return config


def save_config_to_file(config: Config, filepath: str) -> None:
    with open(filepath, "w") as f:
        json.dump(config_to_dict(config), f, indent=2)


def print_config(config: Config) -> None:
    print("************\n** Config **\n************")

    def _walk(obj, prefix=""):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                print(f"{prefix}{f.name.upper()}:")
                _walk(v, prefix + "  ")
            else:
                print(f"{prefix}{f.name.upper()}: {v}")

    _walk(config)


def get_cfg_default() -> Config:
    return Config()
