"""The port's native build (craytpu_torch/native) when several processes
build the same library at once, as pytest-xdist workers do: every one
gets the same published library and none raises."""

import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "craytpu_torch", "native")

# each process waits for the go file, then builds into the shared dir
CHILD = """
import os, sys, time
from craytpu_torch.native import _build
lib_dir, go = sys.argv[1], sys.argv[2]
t_end = time.time() + 120
while not os.path.exists(go) and time.time() < t_end:
    time.sleep(0.001)
print(_build("bvh_builder", lib_dir))
"""


def test_concurrent_native_builds(tmp_path):
    lib_dir = tmp_path / "native"
    lib_dir.mkdir()
    shutil.copy(os.path.join(NATIVE, "bvh_builder.cpp"), lib_dir)
    # a stale build of an older source: removed, but no process's .tmp
    (lib_dir / "libbvh_builder-0000000000000000.so").write_bytes(b"old")
    go = tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(lib_dir),
                               str(go)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    time.sleep(1.0)          # let all four reach the go file
    go.write_text("")
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1, paths
    path = paths.pop()
    assert os.path.dirname(path) == str(lib_dir) and os.path.exists(path)
    assert "failed" not in "".join(e for _, e in outs)
    left = sorted(os.listdir(lib_dir))
    assert left == ["bvh_builder.cpp", os.path.basename(path)], left
