"""rav1e_tpu_torch's C API: its shim (rav1e_tpu_torch/capi/capi.cc) and
example, built with g++ against the shared include/rav1e_tpu.h, print the
same packet lines on the CPU as rav1e_tpu's shim (native/capi.cc) with
examples/capi_encode.c.  Skips where tests/test_capi.py skips."""

import os
import shutil
import subprocess
import sys

import pytest
from torch_threads import one_torch_cpu_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python_config(*args):
    exe = f"python{sys.version_info.major}.{sys.version_info.minor}-config"
    if shutil.which(exe) is None:
        exe = "python3-config"
    out = subprocess.run([exe, *args], capture_output=True, text=True)
    return out.stdout.split()


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_capi_packets_match_reference(tmp_path):
    includes = _python_config("--includes")
    ldflags = _python_config("--ldflags", "--embed")
    if not includes or not ldflags:
        pytest.skip("no python embedding config")
    builds = {
        "ref": [os.path.join(ROOT, "native", "capi.cc"),
                os.path.join(ROOT, "examples", "capi_encode.c")],
        "port": [os.path.join(ROOT, "rav1e_tpu_torch", "capi", "capi.cc"),
                 os.path.join(ROOT, "rav1e_tpu_torch", "capi",
                              "capi_encode.c")],
    }
    procs = {name: subprocess.Popen(
        ["g++", "-O2", *srcs, "-I" + os.path.join(ROOT, "include"),
         *includes, *ldflags, "-o", str(tmp_path / name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, srcs in builds.items()}
    for name, p in procs.items():
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, (name, out[-2000:])

    # the reference's analysis on one device, as the other port tests run it
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               RAV1E_TPU_NO_SHARD="1")
    runs = {name: subprocess.Popen([str(tmp_path / name), *argv],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True, env=env)
            for name, argv in (("ref", []), ("port", ["cpu"]))}
    lines = {}
    for name, run in runs.items():
        out, err = run.communicate(timeout=300)
        assert run.returncode == 0, (name, out, err[-2000:])
        assert "OK: 5 packets" in out, out
        lines[name] = [ln for ln in out.splitlines()
                       if ln.startswith("packet ")]
    assert len(lines["port"]) == 5
    assert lines["port"] == lines["ref"]

    # no device given: the example asks for "cuda", which is refused here
    # (the shim returns no context) rather than run on the CPU
    import torch

    if not torch.cuda.is_available():
        run = subprocess.run([str(tmp_path / "port")], capture_output=True,
                             text=True, env=env, timeout=300)
        assert run.returncode == 4, (run.stdout, run.stderr[-2000:])
        assert "CUDA is not available" in run.stderr
