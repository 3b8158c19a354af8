"""Python-side glue for the C ABI (native/capi.cc).

Counterpart of the reference's ``src/capi.rs``: the C shim embeds the
interpreter and calls these functions with primitive arguments only
(ints/bytes), so the C side stays a thin marshalling layer.

The PyTorch port's copy is imported by its own shim,
``rav1e_tpu_torch/capi/capi.cc``, and adds the string key ``device``: the
torch device of the device stages, ``Config``'s default (the card) unless
the caller sets ``"cpu"``.
"""

from __future__ import annotations

from typing import Optional

from rav1e_tpu_torch import Config, EncoderConfig, EncoderStatus

# C-visible status codes (capi.rs RaEncoderStatus)
RA_SUCCESS = 0
RA_NEED_MORE_DATA = 1
RA_ENOUGH_DATA = 2
RA_LIMIT_REACHED = 3
RA_FAILURE = -1

_INT_KEYS = {
    "width", "height", "speed", "quantizer", "min_quantizer", "bitrate",
    "key_frame_interval", "min_key_frame_interval", "low_latency",
    "still_picture", "threads", "tile_cols", "tile_rows", "bit_depth",
}
_STR_KEYS = ("chroma_sampling", "tune", "device")


def config_new() -> dict:
    return {"speed": 6}


def config_set(cfg: dict, key: str, value: str) -> int:
    """rav1e_config_parse semantics: returns 0 on success, -1 on bad key."""
    key = key.strip()
    if key not in _INT_KEYS and key not in _STR_KEYS:
        return RA_FAILURE
    try:
        cfg[key] = int(value) if key in _INT_KEYS else value
    except ValueError:
        return RA_FAILURE
    return RA_SUCCESS


def context_new(cfg: dict):
    from rav1e_tpu_torch.config import ChromaSampling

    kwargs = dict(
        width=cfg.get("width", 640),
        height=cfg.get("height", 480),
        quantizer=cfg.get("quantizer", 100),
        bitrate=cfg.get("bitrate", 0),
        bit_depth=cfg.get("bit_depth", 8),
        low_latency=bool(cfg.get("low_latency", 0)),
        still_picture=bool(cfg.get("still_picture", 0)),
        min_quantizer=cfg.get("min_quantizer", 0),
    )
    if "key_frame_interval" in cfg:
        kwargs["max_key_frame_interval"] = cfg["key_frame_interval"]
    if "min_key_frame_interval" in cfg:
        kwargs["min_key_frame_interval"] = cfg["min_key_frame_interval"]
    cs = cfg.get("chroma_sampling")
    if cs:
        kwargs["chroma_sampling"] = {
            "420": ChromaSampling.Cs420, "422": ChromaSampling.Cs422,
            "444": ChromaSampling.Cs444, "400": ChromaSampling.Cs400,
        }[cs]
    dev = {"device": cfg["device"]} if "device" in cfg else {}
    config = Config(enc=EncoderConfig(**kwargs), **dev).with_speed_preset(
        cfg.get("speed", 6)
    )
    return config.new_context()


def frame_new(ctx):
    return ctx.new_frame()


def frame_fill_plane(frame, plane: int, data: bytes, stride: int, bytewidth: int) -> int:
    import numpy as np

    try:
        p = frame.planes[plane]
        h, w = p.cfg.height, p.cfg.width
        dt = np.uint8 if bytewidth == 1 else np.uint16
        rows = np.frombuffer(data, dtype=np.uint8).reshape(-1, stride)[:h]
        arr = rows[:, : w * bytewidth].view(dt)[:, :w]
        p.copy_from(arr.astype(dt))
        return RA_SUCCESS
    except Exception:
        return RA_FAILURE


def send_frame(ctx, frame) -> int:
    try:
        ctx.send_frame(frame)
        return RA_SUCCESS
    except EncoderStatus.EnoughData:
        return RA_ENOUGH_DATA
    except Exception:
        return RA_FAILURE


def receive_packet(ctx):
    """Returns (status, data, input_frameno, frame_type_int)."""
    try:
        pkt = ctx.receive_packet()
        return (RA_SUCCESS, pkt.data, pkt.input_frameno, int(pkt.frame_type))
    except EncoderStatus.NeedMoreData:
        return (RA_NEED_MORE_DATA, b"", 0, 0)
    except EncoderStatus.LimitReached:
        return (RA_LIMIT_REACHED, b"", 0, 0)
    except Exception:
        return (RA_FAILURE, b"", 0, 0)


def container_sequence_header(ctx) -> bytes:
    return ctx.container_sequence_header()
