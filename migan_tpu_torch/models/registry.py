"""Model registry: build any registered network from a config dict.

Port of `migan_tpu/models/registry.py` (reference lib/model_zoo/common/
get_model.py:56-103): ``get_model()(cfg)`` returns a `ModelHandle` whose
``init(generator)`` gives the network as an `nn.Module` (random weights
from the `torch.Generator`, or the `pretrained` file's), with the
architecture config beside it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

from torch import nn

_MODELS: Dict[str, Callable] = {}


def register(name: str, version: str = "1"):
    def deco(fn):
        _MODELS[name] = fn
        return fn
    return deco


@dataclass
class ModelHandle:
    cfg: Any
    init: Callable            # init(torch.Generator) -> nn.Module
    name: str = ""


class get_model:
    """get_model()(cfg) like the reference (get_model.py:56-96)."""

    def __call__(self, cfg: Dict[str, Any]) -> ModelHandle:
        build = _MODELS[cfg["type"]]
        handle = build(cfg.get("args") or {})
        handle.name = cfg.get("name", cfg["type"])
        pretrained = cfg.get("pretrained")
        if pretrained:
            random_init = handle.init

            def init(generator, _path=pretrained, _init=random_init):
                return _load_pretrained(_init(generator), _path)

            handle.init = init
        return handle


def _load_pretrained(module: nn.Module, path: str) -> nn.Module:
    """The JAX package's `.npz` or a reference state_dict, into `module`."""
    from ..io.train_weights import load_train_state

    module.load_state_dict(load_train_state(path), strict=True)
    return module


def _fields(cls, args: Dict[str, Any]) -> Dict[str, Any]:
    kw = {k: v for k, v in args.items() if k in cls.__dataclass_fields__}
    if "resample_filter" in kw:
        kw["resample_filter"] = tuple(kw["resample_filter"])
    return kw


def _migan_cfg(args: Dict[str, Any]):
    from .migan import MiganConfig

    kw = _fields(MiganConfig, args)
    kw.setdefault("depthwise", False)
    kw.setdefault("reparametrize", False)
    return MiganConfig(**kw)


@register("migan_encoder")
def _build_migan_encoder(args):
    """The generator's `encoder` (its `nn.ModuleDict` of levels)."""
    from . import migan

    cfg = _migan_cfg(args)
    return ModelHandle(cfg, lambda gen: migan.init_weights(
        migan.Generator(cfg).encoder, gen))


@register("migan_synthesis")
def _build_migan_synthesis(args):
    """The generator's `synthesis` (its `nn.ModuleDict` of levels)."""
    from . import migan

    cfg = _migan_cfg(args)
    return ModelHandle(cfg, lambda gen: migan.init_weights(
        migan.Generator(cfg).synthesis, gen))


@register("migan_generator")
def _build_migan_generator(args):
    """The generator's config merges the encoder's ic_n into the
    synthesis args (reference migan.py:527-544)."""
    from . import migan

    enc_args = args["encoder"]["args"]
    syn_args = args["synthesis"]["args"]
    cfg = _migan_cfg({**syn_args, "ic_n": enc_args.get("ic_n", 4)})
    return ModelHandle(cfg, lambda gen: migan.generator_init(cfg, gen))


@register("migan_discriminator")
def _build_migan_discriminator(args):
    from . import migan

    cfg = _migan_cfg(args)
    return ModelHandle(cfg, lambda gen: migan.discriminator_init(cfg, gen))


def _comodgan_cfg(args: Dict[str, Any]):
    from .comodgan import CoModGANConfig

    kw = _fields(CoModGANConfig, args)
    if "oc_n" in args:  # the encoder's name for w0_dim
        kw["w0_dim"] = args["oc_n"]
    return CoModGANConfig(**kw)


@register("comodgan_generator")
def _build_comodgan_generator(args):
    from . import comodgan

    enc_args = args["encoder"]["args"]
    merged = {**args["synthesis"]["args"],
              "ic_n": enc_args.get("ic_n", 4),
              "oc_n": enc_args.get("oc_n", 1024),
              "use_dropout": enc_args.get("use_dropout", True),
              # the encoder's channel bank is authoritative for its blocks
              "ch_base": enc_args.get("ch_base", 32768)}
    cfg = _comodgan_cfg(merged)
    return ModelHandle(cfg, lambda gen: comodgan.generator_init(cfg, gen))


@register("comodgan_discriminator")
@register("stylegan2_discriminator")
def _build_sg_discriminator(args):
    from . import stylegan

    cfg = stylegan.StyleGANConfig(**_fields(stylegan.StyleGANConfig, args))
    return ModelHandle(cfg, lambda gen: stylegan.init_weights(
        stylegan.Discriminator(cfg), gen))


@register("comodgan_mapping")
@register("stylegan2_mapping")
def _build_mapping(args):
    from . import stylegan

    cfg = stylegan.MappingConfig(**_fields(stylegan.MappingConfig, args))
    return ModelHandle(cfg, lambda gen: stylegan.init_weights(
        stylegan.MappingNetwork(cfg), gen))


def count_params(module: nn.Module) -> int:
    """Every element of the module's state, buffers (noise_const, w_avg)
    included: the JAX package's count of its params pytree."""
    return (sum(p.numel() for p in module.parameters())
            + sum(b.numel() for b in module.buffers()))
