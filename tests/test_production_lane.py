"""Production-config lane (VERDICT r2 item 3).

Every other engine test runs under conftest's CPU + x64 overrides; the
shipped CLI and the multi-device dryrun run under the AMBIENT config
(default backend, f32). A round-2 failure (the `_ci_width` crash) lived
exactly in that gap and was invisible to the suite by construction.
This module subprocess-launches the CLI and `dryrun_multichip` with the
conftest overrides STRIPPED so the children boot like a user's process,
and fails if either regresses.

Reference anchor: SURVEY.md §4 (test plan), §3.1 (the engine must run
end to end).
"""

import os
import subprocess
import sys

import pytest

from svtyper_tpu.simulate import Event, SimConfig, events_to_vcf, simulate_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = [("chr1", 6_000_000)]


def _ambient_env(**extra):
    """Child env with the conftest/test overrides removed, so the child
    boots exactly like a user's process (ambient backend, f32)."""
    env = dict(os.environ)
    for k in ("JAX_PLATFORMS", "JAX_ENABLE_X64", "XLA_FLAGS"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("prod_lane")
    events = [
        Event(["DEL", "DUP", "INV"][i % 3], "chr1",
              150_000 + i * 280_000, 150_000 + i * 280_000 + 700 + 53 * i,
              ["0/0", "0/1", "1/1"][i % 3], var_id="p%d" % i)
        for i in range(12)
    ]
    bam = str(d / "prod.bam")
    simulate_events(bam, REFS, events, SimConfig(depth=25), seed=11,
                    extra_background=800)
    vcf = str(d / "prod.vcf")
    with open(vcf, "w") as fh:
        fh.write(events_to_vcf(events, REFS))
    return bam, vcf, str(d), events


def test_cli_runs_under_ambient_config(fixture):
    """The `svtyper` CLI must exit 0 and genotype every record with NO
    config overrides — the exact invocation shape of a production
    user."""
    bam, vcf, d, events = fixture
    out = os.path.join(d, "ambient.vcf")
    res = subprocess.run(
        [sys.executable, "-m", "svtyper_tpu.cli.classic",
         "-i", vcf, "-B", bam, "-o", out, "-n", "20000"],
        env=_ambient_env(), capture_output=True, timeout=900,
    )
    assert res.returncode == 0, res.stderr.decode()[-3000:]
    with open(out) as fh:
        body = [ln for ln in fh if not ln.startswith("#")]
    assert len(body) == len(events)
    gts = [ln.split("\t")[9].split(":")[0] for ln in body]
    # deep simulated events must produce actual calls, not all-null rows
    assert any(g in ("0/0", "0/1", "1/1") for g in gts), gts


def test_dryrun_multichip_under_ambient_config():
    """`__graft_entry__.dryrun_multichip(8)` — the multi-device
    rehearsal — must pass with only XLA_FLAGS set (virtual CPU mesh
    under the ambient default backend)."""
    res = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        env=_ambient_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        cwd=REPO, capture_output=True, timeout=900,
    )
    assert res.returncode == 0, res.stderr.decode()[-3000:]
    assert b"8 devices ok" in res.stdout, res.stdout.decode()[-500:]
