"""Multi-GB video soak of the port's engine: long-clip sequential + random
access + cache churn (the counterpart of ``scripts/soak_video.py``).

Decodes several GB of pixel data through ``accvlab_tpu_torch.video`` while
tracking peak RSS — catches leaks of frames/packets/decoder contexts that
CI-scale tests can't see. Three passes over one synthetic clip:

1. a full sequential pass through ``_StreamReader`` (decoder-state
   continuity);
2. 400 random frames through ``CreateGopDecoder(gopCacheCapacity=8)`` (rng
   seed 1: GOP cache hits, misses and LRU churn);
3. every 9th frame through ``GopDecoder().DecodeYUV`` (the YUV wire's
   half-byte path).

It prints one JSON line with the JAX script's fields, the frames each pass
decoded and a CRC-32 of each pass's decoded bytes (``checksums``). The
engine is the host's FFmpeg 5 build (``video/csrc/video_engine.cpp``): the
soak runs where those libraries are, with no card.

Run: ``python -u scripts/torch_soak_video.py [n_frames] [WxH] [--workdir DIR]``
(defaults 3600 / 640x480 -> ~3.3 GB decoded across the passes; the clip is
written to, and reused from, ``DIR``, by default ``build/soak_video`` in the
checkout).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from accvlab_tpu_torch.video import CreateGopDecoder, GopDecoder, write_video  # noqa: E402
from accvlab_tpu_torch.video.readers import _StreamReader  # noqa: E402

GOP = 30
RANDOM_FRAMES = 400
YUV_STRIDE = 9


def rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def frame_crc(frame, crc: int) -> int:
    """``crc`` carried over a decoded frame's bytes (an RGB array, or a YUV
    frame's luma then chroma)."""
    if isinstance(frame, np.ndarray):
        return zlib.crc32(np.ascontiguousarray(frame).tobytes(), crc)
    crc = zlib.crc32(np.ascontiguousarray(frame.y).tobytes(), crc)
    return zlib.crc32(np.ascontiguousarray(frame.cbcr).tobytes(), crc)


def write_clip(path: str, n: int, w: int, h: int) -> None:
    """The JAX script's clip: a blurred random background with a moving
    square, ``n`` frames, GOPs of ``GOP``."""
    print(f"encoding {n} frames {w}x{h} ...", file=sys.stderr, flush=True)
    from PIL import Image

    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (h // 8, w // 8, 3), np.uint8)
    bg = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))
    frames_path = os.path.join(os.path.dirname(path), "frames.npy")
    mm = np.lib.format.open_memmap(frames_path, mode="w+", dtype=np.uint8, shape=(n, h, w, 3))
    for i in range(n):
        f = bg.copy()
        x = (i * 7) % (w - 60)
        y = (i * 5) % (h - 60)
        f[y : y + 60, x : x + 60] = (i * 37 % 255, 255 - i % 255, i % 255)
        mm[i] = f
    write_video(path, np.asarray(mm), fps=24, gop_size=GOP)
    del mm
    os.remove(frames_path)


def soak(n: int, w: int, h: int, workdir: str) -> dict:
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"soak_{n}_{w}x{h}.mp4")
    t0 = time.time()
    if not os.path.exists(path):
        write_clip(path, n, w, h)
    enc_s = time.time() - t0
    size_mb = os.path.getsize(path) / 1e6
    frame_mb = w * h * 3 / 1e6
    decoded_mb = 0.0
    rss_after_encode = rss_mb()
    crcs = {"seq": 0, "random": 0, "yuv": 0}
    frames = {"seq": 0, "random": 0, "yuv": 0}

    # 1. full sequential pass (stream reader, decoder-state continuity)
    t1 = time.time()
    r = _StreamReader(path)
    try:
        assert r.num_frames == n, (r.num_frames, n)
        for fid in range(n):
            crcs["seq"] = frame_crc(r.read(fid), crcs["seq"])
            frames["seq"] += 1
            decoded_mb += frame_mb
            if fid % 600 == 0:
                print(f"seq {fid}/{n} rss {rss_mb():.0f} MB", file=sys.stderr, flush=True)
    finally:
        r.close()
    seq_s = time.time() - t1
    rss_after_seq = rss_mb()

    # 2. deep random access through the GOP cache (hits + misses + LRU churn)
    t2 = time.time()
    dec = CreateGopDecoder(gopCacheCapacity=8)
    rng = np.random.default_rng(1)
    hits = 0
    for _ in range(RANDOM_FRAMES):
        fid = int(rng.integers(0, n))
        packets, _, _ = dec.GetGOP([path], [fid], useGOPCache=True)
        (img,) = dec.DecodeFromGOPRGB(packets, [path], [fid])
        crcs["random"] = frame_crc(img, crcs["random"])
        frames["random"] += 1
        decoded_mb += frame_mb
        hits += int(dec.isCacheHit()[0])
    rand_s = time.time() - t2
    rss_after_rand = rss_mb()

    # 3. YUV-wire pass (half-byte path exercised at scale too)
    t3 = time.time()
    dec2 = GopDecoder()
    for fid in range(0, n, YUV_STRIDE):
        (yf,) = dec2.DecodeYUV([path], [fid])
        crcs["yuv"] = frame_crc(yf, crcs["yuv"])
        frames["yuv"] += 1
        decoded_mb += frame_mb / 2
    yuv_s = time.time() - t3

    return {
        "n_frames": n,
        "res": f"{w}x{h}",
        "file_MB": round(size_mb, 1),
        "decoded_GB": round(decoded_mb / 1e3, 2),
        "encode_s": round(enc_s, 1),
        "seq_pass_s": round(seq_s, 1),
        "seq_fps": round(n / seq_s, 1),
        "random_access_s": round(rand_s, 1),
        "random_per_frame_ms": round(rand_s / RANDOM_FRAMES * 1e3, 1),
        "cache_hit_frac": round(hits / RANDOM_FRAMES, 2),
        "yuv_pass_s": round(yuv_s, 1),
        "peak_rss_MB": round(rss_mb(), 1),
        "rss_after_encode_MB": round(rss_after_encode, 1),
        "rss_after_seq_MB": round(rss_after_seq, 1),
        "rss_after_random_MB": round(rss_after_rand, 1),
        "frames": frames,
        "checksums": crcs,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=3600)
    ap.add_argument("res", nargs="?", default="640x480", help="WxH")
    ap.add_argument("--workdir", default=os.path.join(ROOT, "build", "soak_video"))
    args = ap.parse_args(argv)
    w, h = (int(x) for x in args.res.split("x"))
    res = soak(args.n_frames, w, h, args.workdir)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
