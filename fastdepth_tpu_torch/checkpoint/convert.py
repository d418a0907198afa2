"""Offline reference ``.pth`` -> npz checkpoint converter — the port's copy
of ``fastdepth_tpu/checkpoint/convert.py`` (the same npz parameter tree).

The reference's depth checkpoints are **pickled full nn.Modules** inside a
{epoch, best_result, model} dict (reference main.py:49-57); its ImageNet
MobileNet checkpoint is a state_dict with DataParallel 'module.' prefixes
(reference models.py:428-436).  This tool:

* unpickles either format WITHOUT the reference codebase, by installing
  stub classes for the pickled module paths,
* transposes every weight NCHW-world -> NHWC-world
  (OIHW/(C,1,kh,kw)/(Cin,Cout,kh,kw) -> HWIO/HWOI: one permutation
  (2, 3, 1, 0) covers all three),
* infers per-layer channel lists from weight shapes, so the NetAdapt-
  pruned checkpoint (whose architecture exists only inside the pickle,
  SURVEY.md §2) round-trips into an explicit ModelConfig.

The ResNet block tables are the models' own (``models/resnet.py``).
"""

from __future__ import annotations

import sys
import types
from typing import Dict, List, Optional, Tuple

import numpy as np

from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.models.resnet import BOTTLENECK, RESNET_LAYERS

_TO_NHWC = (2, 3, 1, 0)  # OIHW->HWIO; (C,1,kh,kw)->(kh,kw,1,C); convT->HWOI


def _install_unpickle_stubs():
    """Register stub modules/classes so reference pickles resolve.

    nn.Module unpickling restores __dict__ directly (no __init__ call),
    so empty subclasses suffice.
    """
    import torch.nn as nn

    def stub_module(name):
        mod = sys.modules.get(name)
        if mod is None:
            mod = types.ModuleType(name)
            sys.modules[name] = mod
        return mod

    models_mod = stub_module("models")
    for cls in [
        "MobileNetSkipAdd", "MobileNetSkipConcat", "MobileNet", "ResNet",
        "ResNetSkipAdd", "ResNetSkipConcat", "Decoder", "DeConv", "UpConv",
        "UpProj", "NNConv", "BLConv", "ShuffleConv", "Unpool", "Identity",
        "upproj",
    ]:
        if not hasattr(models_mod, cls):
            setattr(models_mod, cls, type(cls, (nn.Module,), {}))

    imagenet_mod = stub_module("imagenet")
    mobilenet_mod = stub_module("imagenet.mobilenet")
    imagenet_mod.mobilenet = mobilenet_mod
    if not hasattr(mobilenet_mod, "MobileNet"):
        mobilenet_mod.MobileNet = type("MobileNet", (nn.Module,), {})

    metrics_mod = stub_module("metrics")
    if not hasattr(metrics_mod, "Result"):
        metrics_mod.Result = type("Result", (object,), {})
    if not hasattr(metrics_mod, "AverageMeter"):
        metrics_mod.AverageMeter = type("AverageMeter", (object,), {})


def load_torch_checkpoint(path: str, return_decoder_class: bool = False):
    """Returns (state_dict {name: np.ndarray}, class_name, epoch, best_result)
    [+ decoder_class_name when requested].

    Handles both the dict envelope and a bare pickled module
    (reference main.py:49-57).

    .. warning:: **Trusted checkpoints only.**  The reference format is a
       full-module pickle, so deserializing it executes arbitrary code by
       construction (``torch.load(weights_only=False)`` is unavoidable
       here).  Only convert checkpoints you obtained from a source you
       trust — e.g. the reference's published download links.  This is a
       property of the reference's format, not of this converter; the
       native ``.npz`` checkpoints this framework writes are data-only.
    """
    import torch
    import torch.nn as nn

    _install_unpickle_stubs()
    # Unknown pickled classes (renamed forks, user subclasses) are stubbed
    # on demand: nn.Module unpickling never calls __init__, so an empty
    # nn.Module subclass under the right module path always suffices.
    for _ in range(64):
        try:
            ckpt = torch.load(path, map_location="cpu", weights_only=False)
            break
        except (ModuleNotFoundError, AttributeError) as e:
            if isinstance(e, ModuleNotFoundError):
                name = e.name
                mod = types.ModuleType(name)
                sys.modules[name] = mod
                # make parent packages resolve too
                if "." in name:
                    parent = name.rsplit(".", 1)[0]
                    if parent in sys.modules:
                        setattr(sys.modules[parent], name.rsplit(".", 1)[1], mod)
            else:
                msg = str(e)
                # "Can't get attribute 'X' on <module 'm' ...>"
                import re

                m = re.search(r"attribute '(\w+)' on <module '([\w\.]+)'", msg)
                if not m:
                    raise
                cls_name, mod_name = m.group(1), m.group(2)
                setattr(sys.modules[mod_name], cls_name, type(cls_name, (nn.Module,), {}))
    else:  # pragma: no cover
        raise RuntimeError(f"could not stub checkpoint classes for {path}")
    epoch, best_result = 0, None
    if isinstance(ckpt, dict) and "model" in ckpt:
        epoch = ckpt.get("epoch", 0)
        best_result = ckpt.get("best_result")
        model = ckpt["model"]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        # ImageNet-style state_dict checkpoint with DataParallel prefix
        sd = {strip_module_prefix(k): v for k, v in ckpt["state_dict"].items()}
        arrays = {k: v.detach().numpy() for k, v in sd.items()}
        if return_decoder_class:
            return arrays, "state_dict", ckpt.get("epoch", 0), None, None
        return arrays, "state_dict", ckpt.get("epoch", 0), None
    else:
        model = ckpt
    sd = model.state_dict()
    arrays = {k: np.asarray(v.detach().numpy()) for k, v in sd.items()}
    if return_decoder_class:
        dec_cls = type(getattr(model, "decoder", None)).__name__ if hasattr(model, "decoder") else None
        return arrays, type(model).__name__, epoch, best_result, dec_cls
    return arrays, type(model).__name__, epoch, best_result


def strip_module_prefix(name: str) -> str:
    """Remove a DataParallel 'module.' prefix (reference models.py:434)."""
    return name[7:] if name.startswith("module.") else name


def _conv(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """A torch Conv2d (+ optional bias) -> {'w'[, 'b']} in NHWC layout."""
    out = {"w": np.transpose(sd[f"{prefix}.weight"], _TO_NHWC)}
    if f"{prefix}.bias" in sd:
        out["b"] = sd[f"{prefix}.bias"]
    return out


def _bn(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    return {
        "scale": sd[f"{prefix}.weight"],
        "bias": sd[f"{prefix}.bias"],
        "mean": sd[f"{prefix}.running_mean"],
        "var": sd[f"{prefix}.running_var"],
    }


def _conv_bn(sd, conv_prefix, bn_prefix) -> Dict:
    d = _conv(sd, conv_prefix)
    d["bn"] = _bn(sd, bn_prefix)
    return d


def convert_mobilenet_encoder(
    sd: Dict[str, np.ndarray], prefix: str = "", seq: bool = False
) -> Tuple[Dict, List[int]]:
    """Encoder weights -> our tree + inferred channel list.

    ``seq=True`` for 'model.{i}.{j}' naming (imagenet/mobilenet.py:40-54
    and the plain-MobileNet depth model, models.py:441); ``seq=False`` for
    'conv{i}.{j}' attribute naming (MobileNetSkipAdd, models.py:674-675).
    """
    name = (lambda i: f"{prefix}model.{i}") if seq else (lambda i: f"{prefix}conv{i}")
    params: Dict = {"conv0": _conv_bn(sd, f"{name(0)}.0", f"{name(0)}.1")}
    channels = [params["conv0"]["w"].shape[-1]]
    for i in range(1, 14):
        p = name(i)
        params[f"conv{i}"] = {
            "dw": _conv_bn(sd, f"{p}.0", f"{p}.1"),
            "pw": _conv_bn(sd, f"{p}.3", f"{p}.4"),
        }
        channels.append(params[f"conv{i}"]["pw"]["w"].shape[-1])
    return params, channels


def convert_fastdepth_skip(
    sd: Dict[str, np.ndarray], skip: str = "add"
) -> Tuple[Dict, ModelConfig]:
    """MobileNetSkipAdd / MobileNetSkipConcat state_dict -> (params, config).

    Decoder naming (models.py:683-698): decode_conv{i} is
    Sequential(depthwise Sequential, pointwise Sequential), so keys are
    'decode_conv{i}.0.0.weight' (dw conv), '.0.1.*' (dw bn),
    '.1.0.weight' (pw conv), '.1.1.*' (pw bn); decode_conv6 is a bare
    pointwise Sequential: '.0.weight', '.1.*'.
    """
    enc, enc_channels = convert_mobilenet_encoder(sd, seq=False)
    decoder: Dict = {}
    dec_channels = []
    for i in range(1, 6):
        p = f"decode_conv{i}"
        decoder[p] = {
            "dw": _conv_bn(sd, f"{p}.0.0", f"{p}.0.1"),
            "pw": _conv_bn(sd, f"{p}.1.0", f"{p}.1.1"),
        }
        dec_channels.append(decoder[p]["pw"]["w"].shape[-1])
    decoder["decode_conv6"] = {"pw": _conv_bn(sd, "decode_conv6.0", "decode_conv6.1")}
    cfg = ModelConfig(
        encoder="mobilenet",
        decoder="nnconv5dw",
        skip=skip,
        encoder_channels=tuple(enc_channels),
        decoder_channels=tuple(dec_channels),
    ).validate()
    return {"encoder": enc, "decoder": decoder}, cfg


def convert_imagenet_mobilenet(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict, List[int]]:
    """ImageNet classifier ckpt -> (encoder_params, head_params, channels)."""
    enc, channels = convert_mobilenet_encoder(sd, seq=True)
    head = {"fc": {"w": np.transpose(sd["fc.weight"], (1, 0)), "b": sd["fc.bias"]}}
    return enc, head, channels


def convert_resnet_encoder(sd: Dict[str, np.ndarray], layers: int) -> Dict:
    """torchvision resnet state_dict -> our encoder tree."""
    blocks = RESNET_LAYERS[layers]
    bottleneck = layers in BOTTLENECK
    params: Dict = {"conv1": _conv_bn(sd, "conv1", "bn1")}
    for s, n in enumerate(blocks, start=1):
        stage: Dict = {}
        for b in range(n):
            pre = f"layer{s}.{b}"
            blk = {
                "conv1": _conv_bn(sd, f"{pre}.conv1", f"{pre}.bn1"),
                "conv2": _conv_bn(sd, f"{pre}.conv2", f"{pre}.bn2"),
            }
            if bottleneck:
                blk["conv3"] = _conv_bn(sd, f"{pre}.conv3", f"{pre}.bn3")
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = _conv_bn(sd, f"{pre}.downsample.0", f"{pre}.downsample.1")
            stage[f"block{b}"] = blk
        params[f"layer{s}"] = stage
    return params


def convert_mobilenet_plain(
    sd: Dict[str, np.ndarray], decoder_class: Optional[str] = None
) -> Tuple[Dict, ModelConfig]:
    """Plain MobileNet + NNConv decoder state_dict -> (params, config).

    This is the format of the released mobilenet-nnconv5 /
    mobilenet-nnconv5dw checkpoints (reference models.py:420-460:
    encoder under 'mobilenet.{i}' Sequential naming, decoder under
    'decoder.conv{1..6}' with NNConv's dw/dense stage structure,
    models.py:224-251)."""
    enc, enc_channels = convert_mobilenet_encoder_seqname(sd)
    # NNConv and BLConv have identical state structure; only the pickled
    # decoder class distinguishes them (models.py:272-294).  The decoder
    # mapping itself is the registry converter's NNConv branch — one
    # implementation, not two copies to keep in sync.
    decoder, dec_name = convert_registry_decoder(
        sd, decoder_class if decoder_class == "BLConv" else "NNConv")
    cfg = ModelConfig(
        encoder="mobilenet",
        decoder=dec_name,
        skip=None,
        encoder_channels=tuple(enc_channels),
        decoder_channels=_infer_decoder_channels(decoder, dec_name),
    )
    return {"encoder": enc, "decoder": decoder}, cfg


def convert_mobilenet_encoder_seqname(sd: Dict[str, np.ndarray]) -> Tuple[Dict, List[int]]:
    """Encoder under 'mobilenet.{i}.{j}' naming (models.py:441)."""
    renamed = {
        "model." + k[len("mobilenet."):]: v
        for k, v in sd.items() if k.startswith("mobilenet.")
    }
    return convert_mobilenet_encoder(renamed, seq=True)


def convert_registry_decoder(
    sd: Dict[str, np.ndarray], decoder_class: str, prefix: str = "decoder."
) -> Tuple[Dict, str]:
    """Any reference registry decoder (models.py:145-333) under
    ``prefix`` -> (our decoders.py param tree, decoder name string).

    Torch naming per class: NNConv/BLConv 'conv{1..6}', DeConv
    'convt{1..5}' + 'convf', UpConv 'upconv{1..5}' + 'convf', UpProj
    'upproj{1..5}' (branch1/branch2) + 'convf', ShuffleConv 'conv{1..4}'.
    dw-ness and kernel size are inferred from weight shapes.
    """
    P = prefix
    dec: Dict = {}

    def stage_conv(base):  # dense conv builder Sequential(conv, bn, relu)
        return {"conv": _conv_bn(sd, f"{base}.0", f"{base}.1")}

    def stage_dwpw(base):  # Sequential(dw Sequential, pw Sequential)
        return {
            "dw": _conv_bn(sd, f"{base}.0.0", f"{base}.0.1"),
            "pw": _conv_bn(sd, f"{base}.1.0", f"{base}.1.1"),
        }

    if decoder_class in ("NNConv", "BLConv", "ShuffleConv"):
        dw = f"{P}conv1.0.0.weight" in sd
        n = 4 if decoder_class == "ShuffleConv" else 5
        for i in range(1, n + 1):
            dec[f"conv{i}" if decoder_class == "ShuffleConv" else f"stage{i}"] = (
                stage_dwpw(f"{P}conv{i}") if dw else stage_conv(f"{P}conv{i}")
            )
        if decoder_class != "ShuffleConv":
            dec["final"] = {"pw": _conv_bn(sd, f"{P}conv6.0", f"{P}conv6.1")}
        first = dec["conv1" if decoder_class == "ShuffleConv" else "stage1"]
        w = first["dw"]["w"] if dw else first["conv"]["w"]
        k = w.shape[0]
        kind = {"NNConv": "nnconv", "BLConv": "blconv", "ShuffleConv": "shuffle"}[decoder_class]
        return dec, f"{kind}{k}{'dw' if dw else ''}"

    if decoder_class == "DeConv":
        dw = f"{P}convt1.0.0.weight" in sd
        for i in range(1, 6):
            dec[f"stage{i}"] = (
                stage_dwpw(f"{P}convt{i}") if dw else stage_conv(f"{P}convt{i}")
            )
        dec["final"] = {"pw": _conv_bn(sd, f"{P}convf.0", f"{P}convf.1")}
        w = dec["stage1"]["dw"]["w"] if dw else dec["stage1"]["conv"]["w"]
        return dec, f"deconv{w.shape[0]}{'dw' if dw else ''}"

    if decoder_class == "UpConv":
        # Sequential(Unpool, Conv2d, BN, ReLU): conv at index 1
        # (models.py:101-107)
        for i in range(1, 6):
            dec[f"stage{i}"] = {"conv": _conv_bn(sd, f"{P}upconv{i}.1", f"{P}upconv{i}.2")}
        dec["final"] = {"pw": _conv_bn(sd, f"{P}convf.0", f"{P}convf.1")}
        return dec, "upconv"

    if decoder_class == "UpProj":
        for i in range(1, 6):
            b = f"{P}upproj{i}"
            dec[f"stage{i}"] = {
                "branch1_conv1": _conv_bn(sd, f"{b}.branch1.0", f"{b}.branch1.1"),
                "branch1_conv2": _conv_bn(sd, f"{b}.branch1.3", f"{b}.branch1.4"),
                "branch2_conv": _conv_bn(sd, f"{b}.branch2.0", f"{b}.branch2.1"),
            }
        dec["final"] = {"pw": _conv_bn(sd, f"{P}convf.0", f"{P}convf.1")}
        return dec, "upproj"

    raise NotImplementedError(f"no converter for decoder class {decoder_class!r}")


def _infer_decoder_channels(decoder: Dict, dec_name: str = "") -> tuple:
    """Stage output channels from a converted registry-decoder tree.

    Shuffle decoders store stages under ``conv{i}`` and derive every
    width from ``in_channels // 4**i`` (decoders.py:93-99) — the config's
    ``decoder_channels`` field is unused for them, so the unpruned-default
    fallback below is the correct record there.

    ``dec_name`` disambiguates the dense-DeConv layout: transpose-conv
    weights are HWOI (kh, kw, cout, cin), so cout lives at ``shape[-2]``
    there, not ``shape[-1]`` like HWIO convs."""
    convt = dec_name.startswith("deconv") and not dec_name.endswith("dw")
    out = []
    for i in range(1, 6):
        stage = decoder.get(f"stage{i}")
        if stage is None:
            break
        if "pw" in stage:
            out.append(stage["pw"]["w"].shape[-1])
        elif "conv" in stage:
            w = stage["conv"]["w"]
            out.append(w.shape[-2] if convt else w.shape[-1])
        elif "branch2_conv" in stage:
            out.append(stage["branch2_conv"]["w"].shape[-1])
    from fastdepth_tpu_torch.config import UNPRUNED_DECODER_CHANNELS

    return tuple(out) if len(out) == 5 else UNPRUNED_DECODER_CHANNELS


def convert_resnet_plain(
    sd: Dict[str, np.ndarray], decoder_class: str
) -> Tuple[Dict, ModelConfig]:
    """Plain ``ResNet`` depth model (models.py:363-418): torchvision
    encoder + biased 1x1 conv2 + any registry decoder."""
    layers = infer_resnet_layers(sd)
    decoder, dec_name = convert_registry_decoder(sd, decoder_class)
    params = {
        "encoder": convert_resnet_encoder(sd, layers),
        "conv2": _conv(sd, "conv2"),
        "decoder": decoder,
    }
    # infer the decoder widths from the converted tree (exactly like
    # convert_mobilenet_plain): recording the default unpruned widths
    # would silently mismatch any re-init from this config for a
    # non-default (pruned/custom) decoder
    cfg = ModelConfig(encoder=f"resnet{layers}", decoder=dec_name, skip=None,
                      decoder_channels=_infer_decoder_channels(
                          decoder, dec_name))
    cfg.validate()
    return params, cfg


def infer_resnet_layers(sd: Dict[str, np.ndarray]) -> int:
    """Recover the resnet depth from a state dict: block counts per stage
    + bottleneck detection (conv3 presence)."""
    bottleneck = "layer1.0.conv3.weight" in sd
    counts = []
    for s in range(1, 5):
        n = 0
        while f"layer{s}.{n}.conv1.weight" in sd:
            n += 1
        counts.append(n)
    for layers, blocks in RESNET_LAYERS.items():
        if list(blocks) == counts and (layers in BOTTLENECK) == bottleneck:
            return layers
    raise ValueError(f"unrecognized resnet block structure: {counts}")


def convert_resnet_depth(
    sd: Dict[str, np.ndarray], skip: Optional[str]
) -> Tuple[Dict, ModelConfig]:
    """ResNetSkipAdd / ResNetSkipConcat / plain-ResNet state_dict ->
    (params, config).  Decoder naming: decode_conv{i} is the dense conv
    builder Sequential(conv, bn, relu) -> keys '.0.weight' / '.1.*'
    (reference models.py:502-513, 598-609); conv2 is a biased 1x1
    (models.py:399,498)."""
    layers = infer_resnet_layers(sd)
    params: Dict = {
        "encoder": convert_resnet_encoder(sd, layers),
        "conv2": _conv(sd, "conv2"),
    }
    decoder: Dict = {}
    for i in range(1, 6):
        decoder[f"decode_conv{i}"] = {
            "conv": _conv_bn(sd, f"decode_conv{i}.0", f"decode_conv{i}.1")
        }
    decoder["decode_conv6"] = {"pw": _conv_bn(sd, "decode_conv6.0", "decode_conv6.1")}
    params["decoder"] = decoder
    cfg = ModelConfig(encoder=f"resnet{layers}", decoder="nnconv5", skip=skip)
    return params, cfg


def convert_checkpoint(path: str) -> Tuple[Dict, ModelConfig, Dict]:
    """Full conversion entry point: torch ckpt path -> (params, config, meta)."""
    sd, class_name, epoch, best_result, dec_cls = load_torch_checkpoint(
        path, return_decoder_class=True
    )
    meta = {"epoch": int(epoch), "source_class": class_name}
    if best_result is not None:
        for f in ("rmse", "mae", "delta1", "absrel", "lg10"):
            if hasattr(best_result, f):
                meta[f"best_{f}"] = float(getattr(best_result, f))
    if class_name == "MobileNetSkipAdd":
        params, cfg = convert_fastdepth_skip(sd, skip="add")
    elif class_name == "MobileNetSkipConcat":
        params, cfg = convert_fastdepth_skip(sd, skip="concat")
    elif class_name == "ResNetSkipAdd":
        params, cfg = convert_resnet_depth(sd, skip="add")
    elif class_name == "ResNetSkipConcat":
        params, cfg = convert_resnet_depth(sd, skip="concat")
    elif class_name == "ResNet" and dec_cls:
        params, cfg = convert_resnet_plain(sd, dec_cls)
    elif (class_name == "MobileNet" or "mobilenet.0.0.weight" in sd) and dec_cls in (
        "DeConv", "UpConv", "UpProj", "ShuffleConv",
    ):
        # plain MobileNet with a non-conv{i}-style registry decoder
        enc, enc_channels = convert_mobilenet_encoder_seqname(sd)
        decoder, dec_name = convert_registry_decoder(sd, dec_cls)
        dec_channels = _infer_decoder_channels(decoder, dec_name)
        params = {"encoder": enc, "decoder": decoder}
        cfg = ModelConfig(
            encoder="mobilenet", decoder=dec_name, skip=None,
            encoder_channels=tuple(enc_channels),
            decoder_channels=dec_channels,
        )
    elif class_name == "MobileNet" or (
        "mobilenet.0.0.weight" in sd and "decoder.conv1.0.0.weight" in sd
    ) or ("mobilenet.0.0.weight" in sd and "decoder.conv1.0.weight" in sd):
        params, cfg = convert_mobilenet_plain(sd, decoder_class=dec_cls)
    elif "layer1.0.conv1.weight" in sd and "decode_conv1.0.weight" in sd:
        # structure sniff for resnet skip models: concat widens
        # decode_conv2's input (768 = 512+256 vs 512, models.py:598-602)
        dc2_in = sd["decode_conv2.0.weight"].shape[1]
        dc1_out = sd["decode_conv1.0.weight"].shape[0]
        params, cfg = convert_resnet_depth(
            sd, skip="add" if dc2_in == dc1_out else "concat"
        )
    elif "conv0.0.weight" in sd and "decode_conv1.0.0.weight" in sd:
        # structure sniff for renamed/pruned variants: additive skips keep
        # decode_conv3's dw input equal to decode_conv2's pw output;
        # concat widens it (models.py:769-777)
        dec2_out = sd["decode_conv2.1.0.weight"].shape[0]
        dw3_in = sd["decode_conv3.0.0.weight"].shape[0]
        params, cfg = convert_fastdepth_skip(
            sd, skip="add" if dw3_in == dec2_out else "concat"
        )
    else:
        raise NotImplementedError(
            f"no converter for pickled class {class_name!r} yet"
        )
    return params, cfg, meta
