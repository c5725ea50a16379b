"""platanus_b_tpu_torch imports and runs its CLI without loading jax.

tests/conftest.py imports jax for the whole session, so every check runs
in a fresh interpreter.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import ast
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest


REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "platanus_b_tpu_torch"


def _run(code: str, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def _sources():
    """The package's Python files, without the kernel build directory."""
    return [p for p in sorted(PORT.rglob("*.py"))
            if p.relative_to(PORT).parts[0] != "build"]


def _all_modules():
    mods = []
    for path in _sources():
        rel = path.relative_to(REPO).with_suffix("")
        if rel.name == "__main__":
            continue
        mods.append(".".join(rel.parts).removesuffix(".__init__"))
    return mods


def test_import_every_module_without_jax():
    mods = _all_modules()
    assert {"platanus_b_tpu_torch.kernels",
            "platanus_b_tpu_torch.parallel.multihost",
            "platanus_b_tpu_torch.parallel.sharding"} <= set(mods)
    code =("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    m for m in sys.modules if m.startswith('jax'))\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cli_help_without_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['platanus_b_tpu_torch', 'assemble', '--help']\n"
            "try:\n"
            "    runpy.run_module('platanus_b_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code in (0, None), e.code\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "-kmer_occ_only" in res.stdout and res.stdout.strip().endswith("ok")


def test_round_commands_without_jax():
    """All 12 commands' --help, and `solve_dbg -combine` and `combine` on a
    missing input ending with a typed error, all in one interpreter that
    never loads jax."""
    code = ("import contextlib, io, sys\n"
            "from platanus_b_tpu_torch.commands.main import COMMANDS, main\n"
            "assert set(COMMANDS) == {'assemble', 'scaffold', 'solve_dbg',"
            " 'gap_close', 'polish', 'merge', 'kmer_divide', 'iterate',"
            " 'divide', 'consensus', 'phase', 'combine'}\n"
            "for cmd in COMMANDS:\n"
            "    out = io.StringIO()\n"
            "    with contextlib.redirect_stdout(out):\n"
            "        try:\n"
            "            main([cmd, '--help'])\n"
            "        except SystemExit as e:\n"
            "            assert e.code in (0, None), (cmd, e.code)\n"
            "    assert '-o' in out.getvalue(), cmd\n"
            "rc = main(['solve_dbg', '-combine', '-c', 'x.fa', '-gc', 'y.fa'])\n"
            "assert rc == 2, rc\n"
            "rc = main(['combine', '-c', 'x.fa', '-gc', 'y.fa', '-o', 'z'])\n"
            "assert rc == 2, rc\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    res = _run(code, {"PLATANUS_B_TPU_TORCH_DEVICE": "cpu"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert res.stderr.count("ERROR(2)") == 2 and "x.fa" in res.stderr


def test_build_parser_and_scaffold_family_without_jax():
    """The modules of the scaffolding and hybrid slices, the lazy imports
    of their functions, and main.build_parser() load no jax."""
    code = ("import sys\n"
            "from platanus_b_tpu_torch.commands import (combine_cmd,"
            " combine_impl, divide_impl, iterate_cmd, orchestrators,"
            " scaffold_cmd, solve_dbg_cmd)\n"
            "from platanus_b_tpu_torch.models import (bubble, combinatorial,"
            " divide, gap_close, hetero, longread, phasing, scaffold)\n"
            "from platanus_b_tpu_torch.ops import align, gapcost, minimizer\n"
            "from platanus_b_tpu_torch.commands.main import build_parser\n"
            "build_parser()\n"
            "assert not [m for m in sys.modules if m == 'platanus_b_tpu'\n"
            "            or m.startswith('platanus_b_tpu.')]\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    m for m in sys.modules if m.startswith('jax'))\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_port_module_names_jax():
    for path in _sources():
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
        assert not re.search(r"\bjax\b", text), path


def test_unknown_command_is_typed_error():
    """An unknown command gets argparse's usage message and exit 2, as in
    the JAX package (its main.py:85)."""
    res = _run("import sys\n"
               "from platanus_b_tpu_torch.commands.main import main\n"
               "sys.exit(main(['foo']))\n")
    assert res.returncode == 2
    assert "usage: platanus_b_tpu_torch" in res.stderr
    assert "invalid choice: 'foo'" in res.stderr


def test_cuda_required_unless_cpu_requested():
    code = ("import torch\n"
            "from platanus_b_tpu_torch.device import select_device, DeviceError\n"
            "if torch.cuda.is_available():\n"
            "    assert select_device().type == 'cuda'\n"
            "else:\n"
            "    try:\n"
            "        select_device()\n"
            "    except DeviceError:\n"
            "        pass\n"
            "    else:\n"
            "        raise AssertionError('no error without a card')\n"
            "print('ok')\n")
    res = _run(code, {"PLATANUS_B_TPU_TORCH_DEVICE": ""})
    assert res.returncode == 0, res.stderr
    res = _run("from platanus_b_tpu_torch.device import select_device\n"
               "print(select_device())\n",
               {"PLATANUS_B_TPU_TORCH_DEVICE": "cpu"})
    assert res.stdout.strip() == "cpu"


def _names_jax_package(name: str | None) -> bool:
    return name is not None and (name == "platanus_b_tpu"
                                 or name.startswith("platanus_b_tpu."))


@pytest.mark.parametrize("path", _sources() + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_jax_package(path):
    """No absolute import, top-level or inside a function, names the JAX
    package or a module of it."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            assert not any(_names_jax_package(a.name) for a in node.names), \
                (path, node.lineno)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not _names_jax_package(node.module), (path, node.lineno)


def test_assemble_runs_without_the_jax_package(tmp_path):
    """Every port module, `assemble --help` and one CPU `assemble` on a
    small simulated genome in one fresh interpreter: no module of the JAX
    package is loaded, and the port's native IO library lies under the
    port's build/ directory."""
    code = textwrap.dedent(f"""\
        import contextlib, importlib, io, os, sys
        import numpy as np
        sys.path.insert(0, {str(REPO / "tests")!r})
        import simdata
        for m in {_all_modules()!r}:
            importlib.import_module(m)
        from platanus_b_tpu_torch import native
        from platanus_b_tpu_torch.commands.main import main
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                main(["assemble", "--help"])
            except SystemExit as e:
                assert e.code in (0, None), e.code
        rng = np.random.default_rng(5)
        g = simdata.random_genome(rng, 2000)
        reads = os.path.join({str(tmp_path)!r}, "reads.fa")
        simdata.write_fasta(reads, simdata.shotgun_reads(rng, g, 100, 20.0,
                                                         0.002))
        out = os.path.join({str(tmp_path)!r}, "out")
        assert main(["assemble", "-f", reads, "-k", "25", "-o", out]) == 0
        assert os.path.getsize(out + "_contig.fa") > 0
        loaded = sorted(m for m in sys.modules if m == "platanus_b_tpu"
                        or m.startswith("platanus_b_tpu."))
        assert not loaded, loaded
        assert "platanus_b_tpu_torch.native" in sys.modules
        print(native._LIB)
        """)
    res = _run(code, {"PLATANUS_B_TPU_TORCH_DEVICE": "cpu"})
    assert res.returncode == 0, res.stderr
    lib = pathlib.Path(res.stdout.strip().splitlines()[-1])
    assert lib.parent == PORT / "build", lib


def test_native_source_is_the_reference():
    """The port builds its IO library from a verbatim copy of the JAX
    package's io_native.cpp."""
    ref = REPO / "platanus_b_tpu" / "native" / "io_native.cpp"
    assert (PORT / "native" / "io_native.cpp").read_bytes() == ref.read_bytes()
