"""Nothing the benchmark runs loads JAX or the JAX package; an
architecture loads the port only when its ``engine_model`` is called, and
no reference loads it at all. Top-level module names are compared whole:
the port's name begins with the JAX package's."""

import json
import subprocess
import sys

import pytest

from perfbench.bench import FORBIDDEN
from perfbench.spec import HERE

from helpers import REPO, TINY

PORT = "llm_d_kv_cache_manager_tpu_torch"
#: every architecture module, the benchmark's and the tests' own, with a
#: tiny configuration of its model type
ARCHITECTURES = [(p, c) for p in sorted((HERE / "architectures").glob("[!_]*.py"))
                 + sorted((TINY / "architectures").glob("*.py"))
                 for c in sorted((TINY / "configs").glob("*.json"))
                 if json.loads(c.read_text())["config"]["model_type"] == p.stem]
REFERENCES = sorted((HERE / "reference").glob("[!_]*.py")) + sorted((TINY / "reference").glob("*.py"))


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


@pytest.mark.parametrize("path, config", ARCHITECTURES, ids=lambda p: p.stem)
def test_architecture_imports_the_port_only_for_its_engine_model(path, config):
    code = (f"import json\nfrom pathlib import Path\nfrom perfbench.spec import load_module\n"
            f"arch = load_module(Path({str(path)!r}))\n"
            f"m = arch.dims(json.loads(Path({str(config)!r}).read_text())['config'])\n"
            f"specs = [arch.block_specs(m, b) for b in range(m.layers + 1)]\n"
            f"import sys\nassert {PORT!r} not in {{n.split('.')[0] for n in sys.modules}}\n"
            f"arch.engine_model(m)")
    loaded = _loaded(code)
    assert PORT in loaded and not loaded & set(FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.stem)
def test_each_reference_imports_nothing_of_the_port(path):
    loaded = _loaded(f"from pathlib import Path\nfrom perfbench.spec import load_module\n"
                     f"load_module(Path({str(path)!r}))")
    assert "torch" in loaded and not loaded & (set(FORBIDDEN) | {PORT})
