"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program; no
file reads the JAX-era benchmarks/ folder."""
import ast
import subprocess
import sys

import tiny
from benchkit import imports

SOURCES = sorted(p for p in tiny.BENCH.rglob("*.py")
                 if "tests" not in p.relative_to(tiny.BENCH).parts)


def imported(path):
    """Top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_top_level_names_compared_whole():
    assert imports.forbidden(["repro_torch", "repro_torch.serving.engine",
                              "jaxtyping", "reprocess", "torch"]) == []
    assert imports.forbidden(["repro", "repro.models", "jax", "jax.numpy",
                              "jaxlib.xla_client", "flax.linen"]) == \
        sorted(["repro", "repro.models", "jax", "jax.numpy",
                "jaxlib.xla_client", "flax.linen"])


def test_no_source_imports_jax_or_the_jax_package():
    assert SOURCES
    for p in SOURCES:
        assert not imports.forbidden(imported(p)), p


def test_reference_imports_nothing_of_the_program():
    for p in (tiny.BENCH / "reference").glob("*.py"):
        assert imported(p) <= {"__future__", "typing", "torch", "reference"}, p


def test_nothing_reads_the_jax_benchmarks_folder():
    for p in SOURCES:
        assert "benchmarks/" not in p.read_text(), p


def test_modules_loaded_by_a_run_pass_the_check():
    """Import every module a run imports, in a fresh interpreter: what it
    loads holds no forbidden name."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import benchkit.harness, benchkit.serve, reference.dense, "
        "reference.moe\n"
        "from benchkit import spec, imports\n"
        "import repro_torch.serving.engine, repro_torch.configs\n"
        "for m in (%r).split(): spec.load_reader(spec.BENCH, m)\n"
        "print(imports.forbidden(sys.modules))\n"
        % (str(tiny.BENCH), str(tiny.ROOT / "src"),
           " ".join(p.stem for p in (tiny.BENCH / "metrics").glob("*.py"))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
