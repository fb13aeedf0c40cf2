"""The examples on the PyTorch/CUDA port (``examples/*_torch.py``): the
quickstart runs on the CPU at its own size, and no example of the port
imports the JAX package, JAX or the benchmark harness."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart_torch", "train_e2e_torch", "serve_decode_torch",
            "compare_algorithms_torch", "quantized_swarm_torch")


def _imports(path) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_only_the_port(name):
    path = os.path.join(ROOT, "examples", name + ".py")
    names = _imports(path)
    assert not names & {"jax", "repro", "benchmarks"}, names
    src = open(path).read()
    assert "--device" in src and "repro_torch" in src


def test_quickstart_torch_on_cpu():
    out = subprocess.run(
        [sys.executable, "examples/quickstart_torch.py", "--device", "cpu",
         "--steps", "3"], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"}, timeout=300,
        check=True).stdout.splitlines()
    steps = [ln for ln in out if ln.startswith("superstep")]
    assert [ln.split()[1] for ln in steps] == ["0", "2"]
    losses = [float(ln.split()[3]) for ln in steps]
    assert all(5.0 < x < 7.0 for x in losses), out
    assert out[-1].startswith("done")


def test_quickstart_torch_refuses_a_missing_gpu():
    """Without --device cpu the example asks for the card, and on a
    machine without one it stops before building anything."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    p = subprocess.run([sys.executable, "examples/quickstart_torch.py",
                        "--steps", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and "no CUDA device" in p.stderr
