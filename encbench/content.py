"""The benchmark's seeded video content, one generator for every traffic mix.

A clip is a run of scenes of ``scene_frames`` frames each; frame 0 of every
scene is a hard cut. Every seed shows the same ``library_scenes`` scenes
(drawn from ``Clip.LIBRARY_SEED``): library scene 0 first, then the others
in an order of the seed's own, and round again, each slot of that order
under grain of the seed's own. So every seed asks the encoder for the same
work in another order, the clip repeats after one round, and a frame
depends on (seed, frame index, the parameters) alone: any window length,
and any order of drawing, gives the same frames.

The content: a textured background panning at a sub-pixel speed, a few
textured objects moving by whole pixels on their own straight paths inside
the frame, and mild grain (camera noise).

Frames are made on ``device`` in a few batched calls per scene and handed
back as host planes: per frame ``[Y, U, V]`` uint8 arrays, 4:2:0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# scene seeds: the seed and the scene index mixed by a large odd multiplier,
# kept inside torch's 63-bit seed range
_MIX = 0x9E3779B97F4A7C15
_SEED_MASK = (1 << 63) - 1


def scene_seed(seed: int, scene: int) -> int:
    return (int(seed) * _MIX + (int(scene) + 1) * 0xBF58476D1CE4E5B9) \
        & _SEED_MASK


def _smooth_noise(g, shape, cell, device):
    """Gaussian noise on a grid ``cell`` pixels apart, upsampled bicubically
    to ``shape``: unit-variance texture with detail at about that scale."""
    h, w = shape
    gh, gw = h // cell + 4, w // cell + 4
    n = torch.randn((1, 1, gh, gw), generator=g, device=device)
    up = F.interpolate(n, scale_factor=cell, mode="bicubic",
                       align_corners=False)
    up = up[..., 2 * cell: 2 * cell + h, 2 * cell: 2 * cell + w]
    return up[0, 0] / up.std().clamp_min(1e-6)


def _texture(g, shape, device, amp):
    """A luma texture: three octaves of smooth noise (64, 16 and 4 px)."""
    t = (_smooth_noise(g, shape, 64, device) * amp[0]
         + _smooth_noise(g, shape, 16, device) * amp[1]
         + _smooth_noise(g, shape, 4, device) * amp[2])
    return t


def _shift(img, dy, dx):
    """``img`` (N, C, H, W) moved by (dy[i], dx[i]) pixels, bilinear, edges
    replicated."""
    n, _, h, w = img.shape
    ys = torch.arange(h, device=img.device, dtype=torch.float32)
    xs = torch.arange(w, device=img.device, dtype=torch.float32)
    gy = (ys[None, :, None] - dy[:, None, None]) * (2.0 / max(h - 1, 1)) - 1
    gx = (xs[None, None, :] - dx[:, None, None]) * (2.0 / max(w - 1, 1)) - 1
    grid = torch.stack(torch.broadcast_tensors(gx, gy), dim=-1)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def _to_u8(x):
    return x.round().clamp(0, 255).to(torch.uint8)


def _natural_scene(p, g, gg, w, h, n, device):
    """(Y (n, h, w), U, V (n, h/2, w/2)) float32 of one natural scene."""
    margin = int(math.ceil(max(abs(v) for v in p["pan_px_per_frame"]) * n)) + 8
    bh, bw = h + 2 * margin, w + 2 * margin
    y_bg = 128.0 + _texture(g, (bh, bw), device, p["texture_amp"])
    c_bg = torch.stack([_smooth_noise(g, (bh // 2, bw // 2), 32, device)
                        for _ in range(2)]) * p["chroma_amp"] + 128.0
    # the pan: the given (x, y) speed, its signs drawn from the seed (the
    # four directions ask for the same work)
    sx, sy = (1 - 2 * torch.randint(0, 2, (2,), generator=g,
                                    device=device)).tolist()
    t = torch.arange(n, device=device, dtype=torch.float32)
    dx = t * p["pan_px_per_frame"][0] * sx
    dy = t * p["pan_px_per_frame"][1] * sy
    y = _shift(y_bg.expand(n, 1, bh, bw), dy, dx)[:, 0,
                                                    margin: margin + h,
                                                    margin: margin + w]
    c = _shift(c_bg[None].expand(n, 2, bh // 2, bw // 2), dy / 2, dx / 2)
    m2 = margin // 2
    c = c[:, :, m2: m2 + h // 2, m2: m2 + w // 2]
    # objects: ellipses with a texture of their own, each on a straight path
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    cy = torch.arange(h // 2, device=device,
                      dtype=torch.float32)[None, :, None] * 2 + 0.5
    cx = torch.arange(w // 2, device=device,
                      dtype=torch.float32)[None, None, :] * 2 + 0.5
    # every seed gets the same sizes, aspects, brightness and colour levels
    # and the same whole-pixel velocities (evenly spread directions), each
    # set in an order of its own; each path stays inside the frame
    lo, hi = p["object_size"]
    m = p["objects"]
    order = [torch.randperm(m, generator=g, device=device).tolist()
             for _ in range(5)]
    level = lambda i: (i + 0.5) / m - 0.5  # evenly spaced in (-0.5, 0.5)
    speed = p["object_px_per_frame"]
    for k in range(m):
        r = torch.rand(2, generator=g, device=device).tolist()
        ry = h * (lo + (hi - lo) * (k + 0.5) / m) / 2
        rx = ry * (1.0 + 0.8 * level(order[0][k]))
        a = 2 * math.pi * order[4][k] / m
        vy, vx = round(speed * math.sin(a)), round(speed * math.cos(a))

        def start(u, size, v, extent):
            lo_, hi_ = size + max(0.0, -v * (n - 1)), \
                extent - size - max(0.0, v * (n - 1))
            return lo_ + u * (hi_ - lo_) if hi_ > lo_ else extent / 2

        y0, x0 = start(r[0], ry, vy, h), start(r[1], rx, vx, w)
        py, px = y0 + t[:, None, None] * vy, x0 + t[:, None, None] * vx
        d = ((yy - py) / ry) ** 2 + ((xx - px) / rx) ** 2
        # a one-pixel soft edge
        alpha = (1.0 - (d.sqrt() - 1.0) * min(rx, ry)).clamp(0, 1)
        side = int(2 * max(rx, ry)) + 8
        tex = 128.0 + 120 * level(order[1][k]) + _texture(
            g, (side, side), device, p["object_texture_amp"])
        oy = (yy - py + side / 2).round().long().clamp(0, side - 1)
        ox = (xx - px + side / 2).round().long().clamp(0, side - 1)
        y = y * (1 - alpha) + tex[oy, ox] * alpha
        ca = (1.0 - (((((cy - py) / ry) ** 2 + ((cx - px) / rx) ** 2).sqrt()
                      - 1.0) * min(rx, ry) / 2)).clamp(0, 1)
        cu = 128.0 + 80 * level(order[2][k])
        cv = 128.0 + 80 * level(order[3][k])
        c = torch.stack([c[:, 0] * (1 - ca) + cu * ca,
                         c[:, 1] * (1 - ca) + cv * ca], dim=1)
    grain = p["grain_sigma"]
    y = y + torch.randn(y.shape, generator=gg, device=device) * grain
    c = c + torch.randn(c.shape, generator=gg, device=device) * (grain / 2)
    return y, c[:, 0], c[:, 1]


class Clip:
    """The frames of one seed: ``frame(i)`` gives frame ``i``'s planes,
    drawing its slot's scene on first use and keeping it; :meth:`draw_all`
    draws every slot, after which no call draws anything."""

    LIBRARY_SEED = 0

    def __init__(self, content: dict, width: int, height: int, seed: int,
                 device="cpu"):
        if width % 2 or height % 2:
            raise ValueError("4:2:0 content needs an even width and height")
        self.p = content
        self.width, self.height = width, height
        self.seed = seed
        self.device = torch.device(device)
        self.scene_frames = int(content["scene_frames"])
        self.library = int(content["library_scenes"])
        g = torch.Generator()
        g.manual_seed(scene_seed(seed, -1))
        self.order = [0] + [1 + int(k) for k in
                            torch.randperm(self.library - 1, generator=g)]
        self._scenes = {}

    def scene(self, s: int):
        """Scene ``s`` as a list of per-frame [Y, U, V] uint8 host arrays:
        slot ``s % library_scenes`` of the seed's round."""
        slot = s % self.library
        if slot not in self._scenes:
            g = torch.Generator(device=self.device)
            gg = torch.Generator(device=self.device)
            g.manual_seed(scene_seed(self.LIBRARY_SEED, self.order[slot]))
            gg.manual_seed(scene_seed(self.seed, slot))
            y, u, v = _natural_scene(self.p, g, gg, self.width, self.height,
                                     self.scene_frames, self.device)
            y, u, v = (_to_u8(a).cpu().numpy() for a in (y, u, v))
            self._scenes[slot] = [[y[i], u[i], v[i]]
                                  for i in range(self.scene_frames)]
        return self._scenes[slot]

    def draw_all(self):
        for s in range(self.library):
            self.scene(s)

    def frame(self, i: int):
        return self.scene(i // self.scene_frames)[i % self.scene_frames]

    def is_cut(self, i: int) -> bool:
        return i % self.scene_frames == 0
