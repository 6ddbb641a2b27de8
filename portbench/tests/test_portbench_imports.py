"""What the benchmark may import: no module under portbench/ imports JAX
or the JAX package (top-level names compared whole: the port's name
begins like the JAX package's), and the reference imports nothing of the
program under test."""

import ast
import subprocess
import sys

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "iaf_tpu"}
FILES = sorted(spec.HERE.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    spec.HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_whole_names_only():
    # "iaf_torch" begins with "iaf_t" but is not "iaf_tpu"
    assert "iaf_torch" not in FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "yardstick.py",
                                  "inputs.py", "judge.py"])
def test_yardstick_takes_nothing_of_the_program(name):
    assert "iaf_torch" not in top_level_imports(spec.HERE / name)


def test_reference_loads_no_program_module():
    code = ("import sys, torch, json\n"
            "from portbench import reference as ref, inputs\n"
            "c = json.load(open('portbench/configs/iaf-paper.json'))['config']\n"
            "c = dict(c, image_size=8, z_size=4, h_size=16, num_blocks=2)\n"
            "P = inputs.weights(c, 1, 'cpu')\n"
            "eps = [torch.randn(2, 4, 4, 4) for _ in range(2)]\n"
            "x = torch.from_numpy(inputs.images(1, 2, 8, 3))\n"
            "ref.forward(c, P, ref.masks(c, 'cpu'), x, eps)\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'iaf_torch', 'jax', 'jaxlib', 'flax', 'iaf_tpu'}\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=spec.ROOT,
                   timeout=120)
