"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole: the port's ``repro_torch`` only begins with ``repro``), and
the reference loads nothing of the port."""
import subprocess
import sys
from pathlib import Path

import run

BENCH = Path(__file__).resolve().parent.parent


def modules_after(code: str) -> set:
    p = subprocess.run(
        [sys.executable, "-c", "import sys\n" + code + "\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(p.stdout.split())


def test_harness_loads_no_jax():
    mods = modules_after(
        f"sys.path[:0] = [{str(BENCH)!r}]\nimport run\n"
        "run.serve('phi3_14b.azure_overload', 4, 1.0, True, rehearse=True)")
    assert "repro_torch" in mods
    assert not mods & set(run.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = modules_after(
        "import importlib.util\n"
        f"s = importlib.util.spec_from_file_location('ref', "
        f"{str(BENCH / 'reference' / 'dense.py')!r})\n"
        "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)")
    assert "torch" in mods
    assert not mods & {"repro_torch", *run.FORBIDDEN}


def test_names_are_compared_whole():
    allowed = ["repro_torch.core", "reprox", "jaxtyping", "flaxen", "torch"]
    assert run.forbidden_modules(allowed) == []
    assert run.forbidden_modules(allowed + ["repro.core", "jax.numpy"]) == [
        "jax", "repro"]
