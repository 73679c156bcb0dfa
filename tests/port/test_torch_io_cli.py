"""Host side of the port: snapshot/stats codecs, scenes, the CLI end to
end against the JAX package, and the import guard."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sphtpu.cli as ref_cli
import sphtpu.io as ref_io
import sphtpu_torch.cli as cli
import sphtpu_torch.io as io
from sphtpu.scenes import iniconds_setup as iniconds_ref
from sphtpu_torch.scenes import iniconds_setup

# the suite runs several pytest workers per machine: keep torch's intra-op
# pool from oversubscribing the cores they share
torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "golden")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize(
    "name", ["1snap.csv", "iso_1snap.csv", "pathological_1snap.csv"]
)
def test_snapshot_bytes_equal_reference(name, tmp_path):
    """Read a golden file with each package's reader, write it with each
    package's writer: same arrays in, same bytes out."""
    src = os.path.join(GOLDEN, name)
    a, b = ref_io.read_snapshot(src), io.read_snapshot(src)
    assert a["constants"] == b["constants"] or name.startswith("patho")
    for k in ("pos", "vel", "K", "rlin", "rho_radial"):
        if a[k] is None:
            assert b[k] is None
        else:
            np.testing.assert_array_equal(a[k], b[k])
    outs = []
    for mod, snap, sub in ((ref_io, a, "ref"), (io, b, "port")):
        outs.append(
            mod.write_snapshot(
                "7", "golden", snap["pos"], snap["vel"], K=snap["K"],
                constants=snap["constants"], rlin=snap["rlin"],
                rho_radial=snap["rho_radial"], root=str(tmp_path / sub),
            )
        )
    assert _read(outs[0]) == _read(outs[1])
    # and the reference reader reads the port's file back bit for bit
    back = ref_io.read_snapshot(outs[1])
    np.testing.assert_array_equal(back["pos"], a["pos"])


def test_stats_file_bytes_equal_reference(tmp_path):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((5, 10))
    paths = []
    for mod, sub in ((ref_io, "ref"), (io, "port")):
        path = str(tmp_path / sub / "stats")
        sf = mod.StatsFile(path)
        for i, row in enumerate(rows):
            sf.update_row(1 + 2 * i, row)
        np.testing.assert_array_equal(sf.up_to(9)[::2], rows)
        sf.close()
        paths.append(path)
    assert os.path.getsize(paths[1]) == 8_000_000
    assert _read(paths[0]) == _read(paths[1])
    assert (io.NSTEPS, io.NFIELDS) == (ref_io.NSTEPS, ref_io.NFIELDS)


@pytest.mark.parametrize(
    "eos,ic_type",
    [("polytropic", "gaussian_sphere"), ("isothermal", "sample_isothermal_sphere")],
)
def test_scene_generators_equal_reference(eos, ic_type, tmp_path):
    pa = iniconds_ref(eos, ic_type, root=str(tmp_path / "ref"), N=300)
    pb = iniconds_setup(eos, ic_type, root=str(tmp_path / "port"), N=300)
    assert _read(pa) == _read(pb)


def test_cli_parser_and_kwargs_match_reference():
    s = "a=true,b=False,c=42,d=4.5,e=1e3,f=hello"
    assert cli.parse_kwargs_string(s) == ref_cli.parse_kwargs_string(s)
    argv = ["--EOS", "polytropic", "--ic_type", "gaussian_sphere"]
    a, b = cli.build_parser().parse_args(argv), ref_cli.build_parser().parse_args(argv)
    for k in ("snapID", "snapInterval", "keepSnaps", "showPlots", "dtype",
              "engine", "gravity", "max_steps", "root"):
        assert getattr(a, k) == getattr(b, k)
    assert a.device is None  # the card unless the caller names the CPU


def test_cli_bad_eos_and_default_device(capsys, tmp_path):
    assert cli.main(["--run", "--EOS", "adiabatic", "--ic_type", "x",
                     "--root", str(tmp_path)]) == 1
    assert "No EOS of type adiabatic exists" in capsys.readouterr().out
    if not torch.cuda.is_available():
        # --run without --device cpu is a run on the card: no CPU fallback
        cli.main(["--generate", "--EOS", "polytropic", "--ic_type",
                  "gaussian_sphere", "--kwargs", "N=100", "--root", str(tmp_path)])
        with pytest.raises(RuntimeError, match="CUDA|cuda"):
            cli.main(["--run", "--EOS", "polytropic", "--ic_type",
                      "gaussian_sphere", "--root", str(tmp_path), "--quiet"])


def test_cli_run_matches_reference(tmp_path):
    """--generate then --run --max-steps 3 at N = 800, float32: the port
    (on the CPU) writes what the JAX CLI writes, to 1e-6 relative."""
    res = {}
    for name, mod, extra in (("ref", ref_cli, []), ("port", cli, ["--device", "cpu"])):
        root = str(tmp_path / name)
        common = ["--EOS", "polytropic", "--ic_type", "gaussian_sphere", "--root", root]
        assert mod.main(["--generate", *common, "--kwargs", "N=800"]) == 0
        assert mod.main(
            ["--run", *common, "--snapID", "1", "--snapInterval", "2",
             "--keepSnaps", "true", "--showPlots", "false", "--max-steps", "3",
             "--quiet", *extra]
        ) == 0
        res[name] = root
    bins = {k: sorted(os.listdir(f"{r}/snapshots/gaussian_sphere/bin")) for k, r in res.items()}
    assert bins["ref"] == bins["port"] == ["1snap.csv", "3snap.csv"]
    a = ref_io.read_snapshot(ref_io.snapshot_path(res["ref"], "gaussian_sphere", "3"))
    b = io.read_snapshot(io.snapshot_path(res["port"], "gaussian_sphere", "3"))
    assert a["constants"]["iterID"] == b["constants"]["iterID"] == 3
    for k in ("pos", "vel", "K"):
        scale = np.abs(a[k]).max()
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6 * scale, err_msg=k)
    np.testing.assert_allclose(b["constants"]["t"], a["constants"]["t"], rtol=1e-6)
    sa = ref_io.StatsFile(f"{res['ref']}/snapshots/gaussian_sphere/stats")
    sb = io.StatsFile(f"{res['port']}/snapshots/gaussian_sphere/stats")
    ha, hb = sa.up_to(4), sb.up_to(4)
    sa.close(), sb.close()
    assert not ha[3].any() and not hb[3].any(), "only 3 rows were written"
    # t, T, V, U, Etot to 1e-6; momenta are cancellation residues in f32
    np.testing.assert_allclose(hb[:3, :5], ha[:3, :5], rtol=1e-6)
    assert np.isfinite(hb[:3]).all()


def test_no_jax_in_the_port():
    """Importing every module of the port, and chip_smoke, pulls in
    neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sphtpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(sphtpu_torch.__path__, 'sphtpu_torch.')]\n"
        "assert len(names) > 25, names\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'jaxlib' or m == 'sphtpu' or m.startswith('sphtpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
