"""Checkpoints: reference ``.pth`` files, and weights carried across from the
JAX package.

The port's parameter names are the reference checkpoint's keys, so a
reference ``best_model.pth`` (MMFN, AIM, CILRS or TransFuser) loads with
``load_state_dict``. The vec and rad variants never run the map ResNet's
stem and layer1, so the port does not build them;
:func:`load_reference_state_dict` drops those keys, which torch saved anyway.

:func:`from_flax_variables` is the inverse of the JAX package's
``convert_mmfn``, ``convert_aim``, ``convert_cilrs`` and
``convert_transfuser``: it takes a ``{"params", "batch_stats"}`` tree of
numpy arrays and returns the port's state_dict. Layout rules:

- flax Conv kernel (kh, kw, I, O) -> torch Conv2d weight (O, I, kh, kw)
- flax Dense kernel (in, out)     -> torch Linear weight (out, in)
- flax BatchNorm scale/bias + batch_stats mean/var -> BatchNorm2d
  weight/bias/running_mean/running_var (num_batches_tracked = 0)
- GRU weight_ih/weight_hh (in, 3H) -> (3H, in); biases unchanged
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

Tree = Mapping[str, object]
StateDict = Dict[str, torch.Tensor]

RESNET18 = (2, 2, 2, 2)
RESNET34 = (3, 4, 6, 3)
# reference keys of the map ResNet's stem and layer1, unused by vec and rad
_MAP_STEM = ("encoder.img_map_encoder.features.conv1.",
             "encoder.img_map_encoder.features.bn1.",
             "encoder.img_map_encoder.features.layer1.")


def strip_ddp_prefix(sd: Mapping[str, object]) -> Dict[str, object]:
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_torch_state_dict(path: str) -> StateDict:
    """Load a .pth checkpoint onto the CPU (tensors, DDP prefix kept)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach() for k, v in sd.items()}


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Load a reference MMFN or baseline state_dict into the port's
    ``model``, strictly, after stripping a DDP prefix and dropping the map
    stem/layer1 keys that a vec or rad model does not own."""
    sd = strip_ddp_prefix(dict(sd))
    own = model.state_dict()
    sd = {k: v for k, v in sd.items() if k in own or not k.startswith(_MAP_STEM)}
    model.load_state_dict(sd, strict=True)


# the ResNets an ImageNet file grafts into: (key pattern, file, skip conv1)
_GRAFTS = (
    (re.compile(r"^(.*\.)?(image_encoder|img_map_encoder)\.features\."), "resnet34", False),
    (re.compile(r"^(.*\.)?lidar_encoder\._model\."), "resnet18", True),
    (re.compile(r"^encoder\.features\."), "resnet18", False),      # CILRS's image ResNet18
)


def load_imagenet_backbones(state_dict: Mapping[str, torch.Tensor],
                            resnet34_path: Optional[str] = None,
                            resnet18_path: Optional[str] = None) -> StateDict:
    """Graft torchvision ImageNet weights into a model's ResNet encoders.

    The reference builds its camera and map encoders from
    ``models.resnet34(pretrained=True)`` and its LiDAR encoder from
    ``models.resnet18(pretrained=True)`` with a freshly initialized 2-channel
    conv1 (model_img.py:22,58-62). Given raw torchvision ``.pth`` state dicts
    (torchvision keys: ``conv1``, ``bn1``, ``layerK.J.*``, ``fc``), this
    returns a copy of ``state_dict`` (the port's keys) with:

    - the ResNet34 in every ``image_encoder.features`` and
      ``img_map_encoder.features`` (MMFN, AIM, TransFuser);
    - the ResNet18 in every ``lidar_encoder._model``, conv1 excepted (the
      2-channel input keeps its init, as the reference's re-made conv);
    - the ResNet18 in CILRS's ``encoder.features``.

    Only tensors the model owns are replaced (the vec and rad map streams
    have no stem or layer1; ``fc`` and ``num_batches_tracked`` are never
    taken), in the model's dtype; the rest is left as it was.

    Deviation from the JAX package's ``load_imagenet_backbones``: that one
    grafts the ResNet34 file into CILRS's ``image_encoder``, a ResNet18, where
    only the blocks that fit are copied and the ResNet18 file never reaches
    it. Here CILRS takes ``resnet18_path``, the network it is. No torchvision
    import: the files are read with ``torch.load``."""
    out = {k: v.clone() for k, v in state_dict.items()}
    files = {"resnet34": resnet34_path, "resnet18": resnet18_path}
    loaded = {name: load_torch_state_dict(path) for name, path in files.items() if path}
    for key in state_dict:
        for pattern, name, skip_conv1 in _GRAFTS:
            m = pattern.match(key)
            if m is None or name not in loaded:
                continue
            tv_key = key[m.end():]
            if tv_key.endswith("num_batches_tracked") or (skip_conv1 and tv_key.startswith("conv1.")):
                break
            src = loaded[name].get(tv_key)
            if src is not None:
                if src.shape != out[key].shape:
                    raise ValueError(f"{name}: {tv_key} has shape {tuple(src.shape)}, "
                                     f"the model's {key} {tuple(out[key].shape)}")
                out[key] = src.to(out[key].dtype).clone()
            break
    return out


# --------------------------------------------------------------------------- #
# JAX (flax) variables -> the port's state_dict
# --------------------------------------------------------------------------- #

def _get(tree: Tree, path: str) -> np.ndarray:
    for part in path.split("/"):
        tree = tree[part]
    return np.asarray(tree)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))   # a writable copy


def _conv(sd: StateDict, key: str, params: Tree, path: str) -> None:
    sd[key] = _tensor(np.transpose(_get(params, path), (3, 2, 0, 1)))


def _dense(sd: StateDict, key: str, params: Tree, path: str, bias: bool = True) -> None:
    sd[f"{key}.weight"] = _tensor(_get(params, f"{path}/kernel").T)
    if bias:
        sd[f"{key}.bias"] = _tensor(_get(params, f"{path}/bias"))


def _layernorm(sd: StateDict, key: str, params: Tree, path: str) -> None:
    sd[f"{key}.weight"] = _tensor(_get(params, f"{path}/scale"))
    sd[f"{key}.bias"] = _tensor(_get(params, f"{path}/bias"))


def _bn(sd: StateDict, key: str, params: Tree, stats: Tree, path: str) -> None:
    _layernorm(sd, key, params, path)
    sd[f"{key}.running_mean"] = _tensor(_get(stats, f"{path}/mean"))
    sd[f"{key}.running_var"] = _tensor(_get(stats, f"{path}/var"))
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def resnet_from_flax(params: Tree, stats: Tree, stage_sizes: Sequence[int],
                     prefix: str = "", first_stage: int = 1) -> StateDict:
    """One flax ResNet subtree -> torchvision-named keys under ``prefix``."""
    sd: StateDict = {}
    if first_stage == 1:
        _conv(sd, f"{prefix}conv1.weight", params, "conv1/kernel")
        _bn(sd, f"{prefix}bn1", params, stats, "bn1")
    for i, blocks in enumerate(stage_sizes):
        if i + 1 < first_stage:
            continue
        for j in range(blocks):
            src, dst = f"layer{i + 1}_{j}", f"{prefix}layer{i + 1}.{j}"
            _conv(sd, f"{dst}.conv1.weight", params, f"{src}/conv1/kernel")
            _bn(sd, f"{dst}.bn1", params, stats, f"{src}/bn1")
            _conv(sd, f"{dst}.conv2.weight", params, f"{src}/conv2/kernel")
            _bn(sd, f"{dst}.bn2", params, stats, f"{src}/bn2")
            if "downsample_conv" in params[src]:
                _conv(sd, f"{dst}.downsample.0.weight", params, f"{src}/downsample_conv/kernel")
                _bn(sd, f"{dst}.downsample.1", params, stats, f"{src}/downsample_bn")
    return sd


def fusion_transformer_from_flax(params: Tree, n_layer: int, prefix: str = "") -> StateDict:
    sd: StateDict = {f"{prefix}pos_emb": _tensor(_get(params, "pos_emb"))}
    _dense(sd, f"{prefix}vel_emb", params, "vel_emb")
    for i in range(n_layer):
        b, fb = f"{prefix}blocks.{i}", f"block_{i}"
        _layernorm(sd, f"{b}.ln1", params, f"{fb}/ln1")
        _layernorm(sd, f"{b}.ln2", params, f"{fb}/ln2")
        for proj in ("key", "query", "value", "proj"):
            _dense(sd, f"{b}.attn.{proj}", params, f"{fb}/attn/{proj}")
        _dense(sd, f"{b}.mlp.0", params, f"{fb}/fc1")
        _dense(sd, f"{b}.mlp.2", params, f"{fb}/fc2")
    _layernorm(sd, f"{prefix}ln_f", params, "ln_f")
    return sd


def vectornet_from_flax(params: Tree, prefix: str = "", subgraph_layers: int = 3) -> StateDict:
    sd: StateDict = {}
    for i in range(subgraph_layers):
        key, path = f"{prefix}lane_subgraph.layers.mlp_{i}.mlp", f"lane_subgraph/mlp_{i}"
        _dense(sd, f"{key}.0", params, f"{path}/Dense_0")
        _layernorm(sd, f"{key}.1", params, f"{path}/LayerNorm_0")
    for key, path, norm in (("pos_emb", "pos", "pos_ln"), ("agent_fusion", "fuse", "fuse_ln"),
                            ("generator", "gen", "gen_ln")):
        _dense(sd, f"{prefix}{key}.0", params, f"{path}_fc1")
        _layernorm(sd, f"{prefix}{key}.1", params, norm)
        _dense(sd, f"{prefix}{key}.3", params, f"{path}_fc2")
    _dense(sd, f"{prefix}L2L.to_qkv", params, "L2L/to_qkv", bias=False)
    _dense(sd, f"{prefix}L2L.to_out.0", params, "L2L/to_out")
    return sd


def radar_gat_from_flax(params: Tree, prefix: str = "", nheads: int = 2) -> StateDict:
    sd: StateDict = {}
    for i in range(nheads):
        sd[f"{prefix}attention_{i}.W"] = _tensor(_get(params, f"attention_{i}/W"))
        sd[f"{prefix}attention_{i}.a"] = _tensor(_get(params, f"attention_{i}/a"))
    _dense(sd, f"{prefix}mlp_1.0", params, "mlp_1")
    _dense(sd, f"{prefix}mlp_2.0", params, "mlp_2")
    return sd


def gru_from_flax(params: Tree, prefix: str = "") -> StateDict:
    """The JAX TorchGRUCell subtree -> ``nn.GRUCell`` keys."""
    sd: StateDict = {}
    for name in ("weight_ih", "weight_hh"):
        sd[f"{prefix}{name}"] = _tensor(_get(params, name).T)
    for name in ("bias_ih", "bias_hh"):
        sd[f"{prefix}{name}"] = _tensor(_get(params, name))
    return sd


def _head_from_flax(sd: StateDict, params: Tree) -> None:
    """The join MLP, the GRU cell and its output layer (MMFN, AIM, TransFuser)."""
    for idx, torch_idx in ((1, 0), (2, 2), (3, 4)):
        _dense(sd, f"join.{torch_idx}", params, f"join_fc{idx}")
    sd.update(gru_from_flax(params["decoder"]["decoder"], "decoder."))
    _dense(sd, "output", params, "decoder/output")


def _aim_from_flax(params: Tree, stats: Tree) -> StateDict:
    sd = resnet_from_flax(params["image_encoder"], stats["image_encoder"], RESNET34,
                          "image_encoder.features.")
    _head_from_flax(sd, params)
    return sd


def _cilrs_from_flax(params: Tree, stats: Tree) -> StateDict:
    sd = resnet_from_flax(params["image_encoder"], stats["image_encoder"], RESNET18,
                          "encoder.features.")
    for key, path in (("vel_in.0", "vel_in_fc1"), ("vel_in.2", "vel_in_fc2"),
                      ("vel_out.0", "vel_out_fc1"), ("vel_out.2", "vel_out_fc2"),
                      ("vel_out.4", "vel_out_fc3")):
        _dense(sd, f"controller.{key}", params, path)
    for i in range(sum(k.startswith("branch_") and k.endswith("_fc1") for k in params)):
        for j, torch_idx in ((1, 0), (2, 2), (3, 4)):
            _dense(sd, f"controller.branches.{i}.{torch_idx}", params, f"branch_{i}_fc{j}")
    return sd


def _transfuser_from_flax(params: Tree, stats: Tree, n_layer: int) -> StateDict:
    sd: StateDict = {}
    for name, sizes, key in (("image_encoder", RESNET34, "image_encoder.features."),
                             ("lidar_encoder", RESNET18, "lidar_encoder._model.")):
        sd.update(resnet_from_flax(params[name], stats[name], sizes, f"encoder.{key}"))
    for k in range(1, 5):
        sd.update(fusion_transformer_from_flax(params[f"transformer{k}"], n_layer,
                                               f"encoder.transformer{k}."))
    _head_from_flax(sd, params)
    return sd


def from_flax_variables(variables: Tree, variant: str, n_layer: int = 8) -> StateDict:
    """A JAX ``{"params", "batch_stats"}`` tree (numpy leaves) -> the port's
    state_dict (CPU tensors). ``variant``: an MMFN variant (``img``, ``vec``,
    ``rad``; the inverse of ``convert_mmfn``) or a baseline (``aim``,
    ``cilrs``, ``transfuser``; the inverse of ``convert_aim``,
    ``convert_cilrs`` or ``convert_transfuser``)."""
    params, stats = variables["params"], variables["batch_stats"]
    if variant == "aim":
        return _aim_from_flax(params, stats)
    if variant == "cilrs":
        return _cilrs_from_flax(params, stats)
    if variant == "transfuser":
        return _transfuser_from_flax(params, stats, n_layer)
    enc, enc_stats = params["encoder"], stats["encoder"]
    sd: StateDict = {}
    for name, sizes, key, first in (
            ("image_encoder", RESNET34, "image_encoder.features.", 1),
            ("img_map_encoder", RESNET34, "img_map_encoder.features.",
             1 if variant == "img" else 2),
            ("lidar_encoder", RESNET18, "lidar_encoder._model.", 1)):
        sd.update(resnet_from_flax(enc[name], enc_stats[name], sizes,
                                   f"encoder.{key}", first))
    for k in range(1, 5):
        sd.update(fusion_transformer_from_flax(enc[f"transformer{k}"], n_layer,
                                               f"encoder.transformer{k}."))
    if variant in ("vec", "rad"):
        sd.update(vectornet_from_flax(enc["vectornet_encoder"], "encoder.vectornet_encoder."))
    if variant == "rad":
        sd.update(radar_gat_from_flax(enc["radar_encoder"], "encoder.radar_encoder."))
    _head_from_flax(sd, params)
    return sd
