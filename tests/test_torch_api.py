"""The port's one-import facade (``repro_torch.api``) against the
reference's ``repro.api``: the same names less the legacy
``build_plan``, every name resolves, the eager names are
``repro_torch.core``'s own objects, and the import loads no model,
trainer or server."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.api as ref_api
import repro_torch.core as tcore
import repro_torch.core.distributions as tdist
from repro_torch import api

ROOT = Path(__file__).resolve().parents[1]


def test_names_are_the_references_less_build_plan():
    assert set(ref_api.__all__) - set(api.__all__) == {"build_plan"}
    assert set(api.__all__) <= set(ref_api.__all__)
    assert api.__all__ == sorted(api.__all__)
    assert dir(api) == api.__all__


@pytest.mark.parametrize("name", sorted(set(ref_api.__all__) - {"build_plan"}))
def test_every_name_resolves(name):
    obj = getattr(api, name)
    assert obj is not None
    if name in api._LAZY:
        module, attr = api._LAZY[name]
        assert module.startswith("repro_torch.") and attr == name
    else:  # eager: the core layer's own object
        assert obj is getattr(tcore, name, None) or obj is getattr(tdist, name)


def test_unknown_name_raises():
    with pytest.raises(AttributeError, match="repro_torch.api"):
        api.build_plan  # noqa: B018


def test_core_reexports_scheme_and_leaf_costs_of():
    from repro_torch.core.plan import leaf_costs_of
    from repro_torch.core.schemes import Scheme

    assert tcore.Scheme is Scheme and tcore.leaf_costs_of is leaf_costs_of


def test_import_loads_no_model_trainer_or_server():
    code = ("import json, sys\nimport repro_torch.api\n"
            "print(json.dumps(sorted(k for k in sys.modules if k.startswith('repro_torch.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for heavy in ("repro_torch.models", "repro_torch.train", "repro_torch.serve"):
        assert not any(m == heavy or m.startswith(heavy + ".") for m in loaded), loaded
