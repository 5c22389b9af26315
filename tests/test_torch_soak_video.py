"""``scripts/torch_soak_video.py`` against ``scripts/soak_video.py`` at 120
frames of 160x96, each in a working directory of its own.

The JAX script runs as written; its clip directory is redirected to this
test's own (the script fixes ``/tmp/accvlab_soak``), and its readers and
decoders are wrapped to count the frames each pass decodes and to carry the
port script's CRC-32 over their bytes. Both soaks must decode the same
frames per pass, hit the GOP cache as often, and give the same checksums.
"""

import importlib.util
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_soak_video as tsoak  # noqa: E402

N, RES = 120, "160x96"
JAX_DIR = "/tmp/accvlab_soak"


def _jax_soak(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["soak_video.py", str(N), RES])
    spec = importlib.util.spec_from_file_location(
        "jax_soak_video", os.path.join(REPO, "scripts", "soak_video.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Path:
    def __init__(self, redirect):
        self._redirect = redirect

    def join(self, a, *rest):
        return os.path.join(self._redirect(a), *rest)

    def __getattr__(self, name):
        return getattr(os.path, name)


class _Os:
    """``os`` for the JAX script, its clip directory moved to ``root``."""

    def __init__(self, root):
        self._root = str(root)
        self.path = _Path(self._redirect)

    def _redirect(self, p):
        return self._root if p == JAX_DIR else p

    def makedirs(self, p, **kw):
        return os.makedirs(self._redirect(p), **kw)

    def __getattr__(self, name):
        return getattr(os, name)


def _recorded(mod, seen):
    """Wrap the JAX script's reader and decoders: per pass the frames
    decoded and their CRC-32."""

    def rec(kind, frame):
        seen["frames"][kind] += 1
        seen["checksums"][kind] = tsoak.frame_crc(frame, seen["checksums"][kind])

    real_reader, real_create, real_gop = mod._StreamReader, mod.CreateGopDecoder, mod.GopDecoder

    class Reader:
        def __init__(self, path):
            self._r = real_reader(path)
            self.num_frames = self._r.num_frames

        def read(self, fid):
            img = self._r.read(fid)
            rec("seq", img)
            return img

        def close(self):
            self._r.close()

    class Proxy:
        def __init__(self, dec):
            self._dec = dec

        def DecodeFromGOPRGB(self, *a, **kw):
            out = self._dec.DecodeFromGOPRGB(*a, **kw)
            for f in out:
                rec("random", f)
            return out

        def DecodeYUV(self, *a, **kw):
            out = self._dec.DecodeYUV(*a, **kw)
            for f in out:
                rec("yuv", f)
            return out

        def __getattr__(self, name):
            return getattr(self._dec, name)

    mod._StreamReader = Reader
    mod.CreateGopDecoder = lambda **kw: Proxy(real_create(**kw))
    mod.GopDecoder = lambda: Proxy(real_gop())


def test_port_soak_equals_jax_soak(tmp_path, monkeypatch, capsys):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jmod = _jax_soak(monkeypatch)
    monkeypatch.setattr(jmod, "os", _Os(jax_dir))
    seen = {"frames": dict.fromkeys(("seq", "random", "yuv"), 0),
            "checksums": dict.fromkeys(("seq", "random", "yuv"), 0)}
    _recorded(jmod, seen)
    capsys.readouterr()
    jmod.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tsoak.main([str(N), RES, "--workdir", str(port_dir)])

    assert os.path.exists(jax_dir / f"soak_{N}_{RES}.mp4")
    assert os.path.exists(port_dir / f"soak_{N}_{RES}.mp4")
    assert got["frames"] == seen["frames"] == {"seq": N, "random": tsoak.RANDOM_FRAMES,
                                               "yuv": -(-N // tsoak.YUV_STRIDE)}
    assert got["checksums"] == seen["checksums"]
    for key in ("n_frames", "res", "file_MB", "decoded_GB", "cache_hit_frac"):
        assert got[key] == want[key], key
    assert 0.0 < got["cache_hit_frac"] < 1.0  # both hits and misses


def test_port_soak_reuses_its_clip(tmp_path):
    res = "64x48"
    first = tsoak.main(["30", res, "--workdir", str(tmp_path)])
    again = tsoak.main(["30", res, "--workdir", str(tmp_path)])
    assert first["checksums"] == again["checksums"] and first["frames"] == again["frames"]
    assert os.listdir(tmp_path) == [f"soak_30_{res}.mp4"]
    assert np.isfinite(again["peak_rss_MB"])
