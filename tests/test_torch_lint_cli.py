"""The port's program linter CLI (`paddle_tpu_torch.tools.lint_cli`)
against the JAX package's (tests/test_program_analysis.py:694-738), on
the CPU.

- `--golden --json` over tests/fixtures/golden/: each fixture's codes,
  by count, equal the JAX CLI's, plain and through `--passes default`;
  the text output's summary lines;
- a model dir that is clean exits 0 and one that is corrupted exits 1
  naming its code, for an export saved by either package;
- each of the selftest's 7 corruptions reports its code, with the JAX
  package's codes by count on the same corruption of the same program;
  `--selftest --use_gpu=0` exits 0;
- `--mesh`, `--hbm-gb`, `--zero` and `--donation` raise SystemExit
  naming ROADMAP A9 and A2.
"""

import collections
import json
import os

import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import analysis as janalysis
from paddle_tpu.tools import lint_cli as jlint
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch.obs import registry as tregistry
from paddle_tpu_torch.tools import lint_cli as tlint

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_port_registry():
    tregistry.reset_registry()
    yield


def _codes(docs):
    return {d["target"]: collections.Counter(x["code"]
                                             for x in d["diagnostics"])
            for d in docs}


@pytest.mark.parametrize("passes", [None, "default"])
def test_golden_codes_equal_jax(capsys, passes):
    extra = ["--passes", passes] if passes else []
    assert jlint.main(["--golden", "--json"] + extra) == 0
    want = json.loads(capsys.readouterr().out)
    assert tlint.main(["--golden", "--json"] + extra) == 0
    got = json.loads(capsys.readouterr().out)
    assert isinstance(got, list) and len(got) >= 5
    assert _codes(got) == _codes(want)
    assert [d["errors"] for d in got] == [d["errors"] for d in want] \
        == [0] * len(got)


def test_golden_text(capsys):
    assert tlint.main(["--golden", "--quiet"]) == 0
    out = capsys.readouterr().out
    assert "0 error(s)" in out and "transformer.json" in out


def _export(fluid, path, which):
    main, startup, loss, _ = (jlint if which == "jax"
                              else tlint)._build_train_program()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        if which == "jax":
            fluid.io.save_inference_model(
                path, ["x", "y"], [loss], exe, main_program=main,
                bucket_hints={"batch_buckets": [1, 8]})
        else:
            fluid.io.save_inference_model(
                path, ["x", "y"], [loss], scope, main,
                bucket_hints={"batch_buckets": [1, 8]})


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_model_dir_clean_and_corrupted(tmp_path, capsys, which):
    _export(jfluid if which == "jax" else tfluid, str(tmp_path), which)
    assert tlint.main([str(tmp_path), "--quiet", "--use_gpu=0"]) == 0
    assert "0 warning(s)" in capsys.readouterr().out
    assert tlint.main([str(tmp_path), "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jlint.main([str(tmp_path), "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert _codes([got]) == _codes([want])
    path = os.path.join(str(tmp_path), "__model__")
    with open(path) as f:
        meta = json.load(f)
    meta["program"]["blocks"][0]["ops"][0]["type"] = "nope_op"
    with open(path, "w") as f:
        json.dump(meta, f)
    assert tlint.main([str(tmp_path), "--quiet"]) == 1
    assert "V001" in capsys.readouterr().out
    assert tlint.main([str(tmp_path), "--suppress", "V001,V002,V003",
                       "--quiet"]) in (0, 1)


@pytest.mark.parametrize("index", range(7))
def test_selftest_corruption_reports_its_code(index):
    tmain, _, tloss, tparam = tlint._build_train_program()
    jmain, _, jloss, jparam = jlint._build_train_program()
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    label, code, tmutate = tlint._corruptions(tmain, tloss, tparam)[index]
    jlabel, jcode, jmutate = jlint._corruptions(jmain, jloss,
                                                jparam)[index]
    assert (label, code) == (jlabel, jcode)
    tprog, jprog = tmain.clone(), jmain.clone()
    tmutate(tprog)
    jmutate(jprog)
    got = tanalysis.check_program(tprog, level="full", fetches=[tloss],
                                  publish=False)
    want = janalysis.check_program(jprog, level="full", fetches=[jloss],
                                   publish=False)
    assert got.has(code), (label, got.codes())
    assert collections.Counter(d.code for d in got.diagnostics) == \
        collections.Counter(d.code for d in want.diagnostics)


def test_selftest_on_the_cpu(capsys):
    assert tlint.main(["--selftest", "--use_gpu=0"]) == 0
    out = capsys.readouterr().out
    assert "selftest green" in out and "7 seeded corruptions" in out
    assert "ROADMAP A9" in out and "ROADMAP A2" in out


@pytest.mark.parametrize("argv,item", [
    (["--golden", "--mesh", "dp=4,mp=2"], "A9"),
    (["--golden", "--hbm-gb", "16"], "A9"),
    (["--golden", "--zero", "1"], "A9"),
    (["--golden", "--donation"], "A2"),
    (["--selftest", "--mesh", "dp=4,mp=2"], "A9"),
])
def test_waiting_options_name_their_item(argv, item):
    with pytest.raises(SystemExit, match="ROADMAP " + item):
        tlint.main(argv)
