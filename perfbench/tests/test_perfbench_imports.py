"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import subprocess
import sys

from perfbench.bench import FORBIDDEN

from helpers import REPO


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_import_graph_has_no_jax():
    loaded = _loaded("import perfbench.run, perfbench.bench, perfbench.sweep, perfbench.readings\n"
                     "import perfbench.pod as p\n"
                     "import llm_d_kv_cache_manager_tpu_torch.server.serve\n"
                     "from perfbench.spec import metric, traffic_kind, HERE\n"
                     "[metric(f.stem) for f in (HERE / 'metrics').glob('*.py')]\n"
                     "traffic_kind('sessions')")
    assert "llm_d_kv_cache_manager_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    loaded = _loaded("import perfbench.reference.qwen3, perfbench.check, perfbench.weights")
    assert "torch" in loaded
    assert not loaded & (set(FORBIDDEN) | {"llm_d_kv_cache_manager_tpu_torch"})
