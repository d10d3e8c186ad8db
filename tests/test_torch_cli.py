"""Port parity, CLI: the port's ``rhf`` (with ``--gradient`` and
``--polarizability``), ``uhf``, ``mp2``, ``ccsd``, ``fci``, ``cis``, ``eom``,
``optimize``, ``frequencies`` and ``info`` subcommands on the CPU
(``--device cpu``) against the JAX CLI run in process as tests/test_cli.py
runs it: every printed line equal, but for the wall time and the SCF
iteration count on the first line; and the port's checkpoint, resume,
trace and verbose flags."""

import glob
import os
import re

import pytest

from qchem_rs_tpu import cli as jax_cli
from qchem_rs_tpu_torch import cli
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _files(mol, basis="STO-3G"):
    return ["-b", os.path.join(DATA, "basis", f"{basis}.json"),
            "-m", os.path.join(DATA, "mol", f"{mol}.json")]


def _run(main, argv, capsys, device=()):
    rc = main([*argv, *device])
    return rc, capsys.readouterr().out.splitlines()


def _iterations(line) -> int:
    return int(re.search(r"after (\d+) (SCF )?iterations", line).group(1))


def _printed(lines):
    """The lines with the first one's wall time and iteration count masked
    and a printed negative zero ("-0.000000", a value of order 1e-16 on
    either side of 0) read as zero."""
    first = re.sub(r"after \d+ (SCF )?iterations and \d+\.\d\ds$", "after <n> iterations",
                   lines[0])
    return [first] + [re.sub(r"-(0\.0+)(?!\d)", r" \1", line) for line in lines[1:]]


CASES = {
    "rhf charge -1 (hydroxide)": ["rhf", *_files("hydroxyl"), "--charge", "-1"],
    "rhf mixing 0.5": ["rhf", *_files("water"), "--mixing", "0.5"],
    "rhf dipole mulliken": ["rhf", *_files("water"), "--dipole", "--mulliken"],
    "rhf field": ["rhf", *_files("water"), "--field", "0", "0", "0.001", "--dipole"],
    "rhf level shift": ["rhf", *_files("water"), "--level-shift", "0.3", "--epsilon", "1e-8"],
    "rhf pair charge mulliken": ["rhf", *_files("water"), "--fock-mode", "pair", "-c", "2",
                                 "--mulliken"],
    "uhf cation dipole mulliken": ["uhf", *_files("water"), "-c", "1", "-s", "2", "--dipole",
                                   "--mulliken"],
    "info": ["info", *_files("water", "6-31G")],
    "mp2 frozen core auto": ["mp2", *_files("water"), "--epsilon", "1e-10", "--frozen-core",
                             "auto"],
    "mp2 pair": ["mp2", *_files("water"), "--epsilon", "1e-10", "--fock-mode", "pair"],
    "uhf mp2 (UMP2)": ["mp2", *_files("hydroxyl"), "--epsilon", "1e-10", "-s", "2",
                       "--max-iterations", "300"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_prints_the_jax_lines(capsys, case):
    argv = CASES[case]
    rc_ref, ref = _run(jax_cli.main, argv, capsys)
    device = () if argv[0] == "info" else ("--device", "cpu")
    rc, out = _run(cli.main, argv, capsys, device)
    assert rc == rc_ref == 0
    assert len(out) >= 4 and _printed(out) == _printed(ref)
    if argv[0] != "info":  # the two packages stop within one pass of each other
        assert abs(_iterations(out[0]) - _iterations(ref[0])) <= 1


def test_rhf_charge_and_mixing_change_the_run(capsys):
    # the flags reach the config: the hydroxide anion and a damped run
    _, anion = _run(cli.main, ["rhf", *_files("hydroxyl"), "-c", "-1", "--device", "cpu"], capsys)
    assert anion[3] == "hartree fock energy: -74.057"
    base = ["rhf", *_files("water"), "--device", "cpu"]
    _, plain = _run(cli.main, base, capsys)
    _, damped = _run(cli.main, [*base, "--mixing", "0.5"], capsys)
    iterations = [_iterations(x[0]) for x in (plain, damped)]
    assert damped[3] == plain[3] and iterations[1] > iterations[0]


@pytest.mark.parametrize("kind", ["rhf", "uhf"])
def test_checkpoint_then_resume(capsys, tmp_path, kind):
    path = str(tmp_path / f"{kind}.npz")
    base = [kind, *_files("water"), "--epsilon", "1e-10", "--device", "cpu"]
    rc, first = _run(cli.main, [*base, "--checkpoint", path], capsys)
    assert rc == 0 and os.path.exists(path)
    rc, resumed = _run(cli.main, [*base, "--resume", path], capsys)
    assert rc == 0 and resumed[1:4] == first[1:4]
    assert _iterations(resumed[0]) <= 2
    # the JAX CLI resumes from the port's checkpoint too
    rc, jax_resumed = _run(jax_cli.main, [*base[:-2], "--resume", path], capsys)
    assert rc == 0 and jax_resumed[1:4] == first[1:4]
    other = "uhf" if kind == "rhf" else "rhf"
    rc = cli.main([other, *_files("water"), "--resume", path, "--device", "cpu"])
    assert rc == 2 and "expected" in capsys.readouterr().err


def test_trace_dir_writes_a_trace(capsys, tmp_path):
    rc, _ = _run(cli.main, ["rhf", *_files("hydrogen"), "--trace-dir", str(tmp_path / "trace"),
                            "--device", "cpu"], capsys)
    traces = glob.glob(str(tmp_path / "trace" / "trace.*.json"))
    assert rc == 0 and len(traces) == 1 and os.path.getsize(traces[0]) > 0


def test_verbose_logs_every_iteration(capsys):
    rc, out = _run(cli.main, ["--verbose", "rhf", *_files("hydrogen"), "--device", "cpu"], capsys)
    n = _iterations([x for x in out if "converged" in x][0])
    assert rc == 0 and sum(x.startswith("iteration ") for x in out) == n + 1


POST_HF = ["--epsilon", "1e-10"]
POST_HF_CASES = {
    "ccsd triples": ["ccsd", *_files("water"), *POST_HF, "--triples"],
    "ccsd frozen core": ["ccsd", *_files("water"), *POST_HF, "--frozen-core", "auto"],
    "uccsd triples (OH)": ["ccsd", *_files("hydroxyl"), "--epsilon", "1e-12", "-s", "2",
                           "--max-iterations", "300", "--triples"],
    "fci": ["fci", *_files("water"), *POST_HF, "--nroots", "2"],
    "cis tdhf triplet": ["cis", *_files("water"), *POST_HF, "--tdhf", "--triplet"],
    "cis pair davidson": ["cis", *_files("water"), *POST_HF, "--fock-mode", "pair",
                          "--solver", "davidson"],
    "eom": ["eom", *_files("water"), *POST_HF],
    "eom ip": ["eom", *_files("water"), *POST_HF, "--ip"],
    "eom matrix-free spatial": ["eom", *_files("water"), *POST_HF, "--matrix-free",
                                "--formulation", "spatial", "--nstates", "2"],
    "eom ea": ["eom", *_files("water"), *POST_HF, "--ea"],
    "eom oscillator strengths": ["eom", *_files("water"), *POST_HF, "--oscillator-strengths",
                                 "--nstates", "4"],
    "ucis (OH)": ["cis", *_files("hydroxyl"), "--epsilon", "1e-12", "-s", "2",
                  "--max-iterations", "300"],
}


def _unsigned_zeros(line):
    """A printed negative zero ("-0.000000", a value of order 1e-16 on
    either side of 0) read as zero, its padding with it."""
    return " ".join(re.sub(r"(?<![\d.])-(0\.0+)(?!\d)", r" \1", line).split())


def _post_hf_printed(lines):
    """The lines with the wall time and the SCF iteration count of the
    first line masked, and negative zeros read as zero."""
    first = re.sub(r"\d+\.\d\ds\b", "<t>s", lines[0])
    first = re.sub(r"(\(|after )\d+ SCF", r"\1<n> SCF", first)
    return [first] + [_unsigned_zeros(line) for line in lines[1:]]


@pytest.mark.parametrize("case", sorted(POST_HF_CASES))
def test_post_hf_prints_the_jax_lines(capsys, case):
    argv = POST_HF_CASES[case]
    rc_ref, ref = _run(jax_cli.main, argv, capsys)
    rc, out = _run(cli.main, argv, capsys, ("--device", "cpu"))
    assert rc == rc_ref == 0
    assert len(out) >= 3 and _post_hf_printed(out) == _post_hf_printed(ref)


GEOMETRY_CASES = {
    "rhf gradient": ["rhf", *_files("water"), "--epsilon", "1e-11", "--max-iterations", "200",
                     "--gradient"],
    "rhf polarizability": ["rhf", *_files("water"), "--epsilon", "1e-10", "--polarizability"],
    "optimize": ["optimize", *_files("hydrogen"), "--epsilon", "1e-11", "--gtol", "1e-7"],
    "frequencies thermo": ["frequencies", *_files("hydrogen"), "--epsilon", "1e-11", "--thermo",
                           "--symmetry-number", "2"],
}


def _geometry_printed(lines):
    """The lines with the first one's elapsed time and count masked (SCF
    iterations, or the optimizer's evaluations), negative zeros read as
    zero, and the optimizer's final max |gradient| (below 1e-6 at --gtol
    1e-7) masked: L-BFGS-B's path past its first, 1-Bohr trial step turns
    on gradient differences of 1e-16, so the two packages take 7 or 8
    evaluations to the same geometry and energy (to their printed digits)
    and stop at residuals of 1e-10 to 1e-9 that differ."""
    first = re.sub(r"\d+\.\d\ds$", "<t>s", lines[0])
    first = re.sub(r"after \d+ (iterations|energy/gradient)", r"after <n> \1", first)
    rest = []
    for line in lines[1:]:
        m = re.fullmatch(r"max \|gradient\|: (\S+) Hartree/Bohr", line)
        if m and float(m.group(1)) < 1e-6:
            line = "max |gradient|: <1e-6 Hartree/Bohr"
        rest.append(_unsigned_zeros(line))
    return [first] + rest


@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_geometry_tier_prints_the_jax_lines(capsys, case):
    argv = GEOMETRY_CASES[case]
    rc_ref, ref = _run(jax_cli.main, argv, capsys)
    rc, out = _run(cli.main, argv, capsys, ("--device", "cpu"))
    assert rc == rc_ref == 0
    assert len(out) >= 4 and _geometry_printed(out) == _geometry_printed(ref)
