"""Smoke run of the shipped ``svtyper`` genotype path on one NVIDIA GPU.

Drives the CLI (``svtyper_tpu.cli.classic.main``, the ``svtyper``
console script) in this process on seeded simulated data, and checks
what comes out:

1. device and card: the card's name and power limit, JAX's devices; the
   default backend must be ``gpu``;
2. host path: the native BAM decoder must load (it is built from the
   committed C++ source on first use);
3. fixtures from ``bench.py``'s own generators: 4,096 DEL/DEL/DEL/DUP/INV
   events at 30x (2x150 bp, insert 350/40) and a breakend (BND) fixture;
4. the f32 CLI, the shipped default, with its stage times and the
   compiled engine step's memory analysis;
5. determinism: a second f32 CLI run must be byte-identical;
6. oracle parity: the x64 device run must be byte-identical to
   ``--engine oracle``; the f32 run's differences from the oracle are
   counted per FORMAT key, and its genotypes must meet the bench's
   concordance floors against the simulated truth;
7. the engine's shard_map program on one card must give rows
   byte-identical to the plain program.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Any failed phase raises and ends the run with a non-zero exit.

Everything runs in one process: a second JAX process on the card would
fail for want of device memory. Without ``--four`` the run is held to
the first card (``CUDA_VISIBLE_DEVICES=0`` unless already set).

``--four`` runs only the path across cards and its comparison: the
engine over the first four devices against the engine on the first one,
on the fixture of phase 3; the last line then has ``"count": 4``.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

N_EVENTS = 4096
N_BND_EVENTS = 300
CONC_FLOOR_MAIN = 0.97  # bench.py's accuracy-gate floors
CONC_FLOOR_BND = 0.93


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return "; ".join(l.strip() for l in out.splitlines() if l.strip())


def read_vcf(path: str):
    """→ (header lines, records as lists of tab-separated columns)."""
    header, records = [], []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("#"):
                header.append(line)
            else:
                records.append(line.split("\t"))
    return header, records


def format_key_diffs(path_a: str, path_b: str) -> dict:
    """Count, per FORMAT key (and QUAL), the records whose first sample's
    value differs between two VCFs of the same records. Raises if the
    two files differ anywhere else."""
    head_a, recs_a = read_vcf(path_a)
    head_b, recs_b = read_vcf(path_b)
    if head_a != head_b:
        raise AssertionError("headers differ: %s vs %s" % (path_a, path_b))
    if len(recs_a) != len(recs_b):
        raise AssertionError(
            "%d vs %d records" % (len(recs_a), len(recs_b))
        )
    diffs: dict = {}
    for ra, rb in zip(recs_a, recs_b):
        if ra[:5] + ra[6:8] != rb[:5] + rb[6:8]:
            raise AssertionError("record mismatch: %s vs %s" % (ra[:3], rb[:3]))
        if ra[5] != rb[5]:
            diffs["QUAL"] = diffs.get("QUAL", 0) + 1
        va = dict(zip(ra[8].split(":"), ra[9].split(":")))
        vb = dict(zip(rb[8].split(":"), rb[9].split(":")))
        for key in sorted(set(va) | set(vb)):
            if va.get(key) != vb.get(key):
                diffs[key] = diffs.get(key, 0) + 1
    return diffs


def concordance(path: str, truth: dict):
    """→ (agreeing, evaluated): first-sample GT against ``truth`` (record
    ID → genotype string) over the records that have a truth."""
    _, recs = read_vcf(path)
    ok = n = 0
    for rec in recs:
        want = truth.get(rec[2])
        if want is None:
            continue
        n += 1
        ok += rec[9].split(":")[0] == want
    return ok, n


def same_bytes(path_a: str, path_b: str, what: str) -> None:
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        a, b = fa.read(), fb.read()
    if a != b:
        raise AssertionError("%s: outputs differ (%s vs %s)"
                             % (what, path_a, path_b))
    print("%s: byte-identical (%d bytes)" % (what, len(a)))


def render_rows(vcf_path: str, sample_name: str, rows) -> list:
    """The CLI's FORMAT emission of engine ``rows`` onto the records of
    ``vcf_path``: one output line per record."""
    from svtyper_tpu.output import add_format_headers, apply_variant
    from svtyper_tpu.vcfio.model import Variant, Vcf
    from svtyper_tpu.vcfio.reader import read_vcf_lines

    vcf = Vcf()
    with open(vcf_path) as fh:
        header, body = read_vcf_lines(fh)
        vcf.add_header(header)
        add_format_headers(vcf)
        vcf.add_sample(sample_name)
        out = []
        for line, row in zip(body, rows):
            v = Variant(line, vcf)
            apply_variant(v, [sample_name], row)
            out.append(v.get_var_string())
    return out


class Phase:
    """Prints a phase's name and wall time; never swallows its error."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print("== %s" % self.name, flush=True)
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print("   %s done in %.2f s" % (self.name, time.time() - self.t0),
                  flush=True)
        return False


def _print_cli_stats(label: str, st: dict) -> None:
    print(
        "%s: %d variants, genotype wall %.3f s (%.1f variants/s), first "
        "chunk %.3f s, prep %.3f s, send %.3f s, sync %.3f s, %d chunks"
        % (label, st["n_variants"], st["genotype_wall_s"],
           st["n_variants"] / st["genotype_wall_s"],
           st["first_chunk_s"] or 0.0, st["prep_s"], st["send_s"],
           st["sync_s"], st["chunks"])
    )


def _load_sample(bam_path: str, lib_json: str):
    from svtyper_tpu.bamio.bam import open_bam
    from svtyper_tpu.stats import Sample

    return Sample.from_lib_info(open_bam(bam_path),
                                Sample.load_lib_info(lib_json))


def _breakpoints(vcf_path: str):
    from svtyper_tpu.breakpoints import resolve_breakpoint
    from svtyper_tpu.vcfio.model import Variant, Vcf
    from svtyper_tpu.vcfio.reader import read_vcf_lines

    vcf = Vcf()
    with open(vcf_path) as fh:
        header, body = read_vcf_lines(fh)
        vcf.add_header(header)
        return [resolve_breakpoint(Variant(line, vcf)) for line in body]


def _engine_rows(engine, bps):
    t0 = time.time()
    rows = engine.genotype_all(bps)
    return rows, time.time() - t0


def build_fixtures(work: str, with_bnd: bool):
    import bench

    with Phase("fixture (seeded simulation, set-up)"):
        t0 = time.time()
        bam, vcf = bench.build_fixture(n_variants=N_EVENTS, depth=30,
                                       cache=work)
        print("main fixture: %d events, BAM %d bytes, built in %.1f s"
              % (N_EVENTS, os.path.getsize(bam), time.time() - t0))
        with open(vcf + ".truth.json") as fh:
            truth = json.load(fh)
        bnd = None
        if with_bnd:
            t0 = time.time()
            bnd = bench.build_bnd_fixture(n_events=N_BND_EVENTS, cache=work)
            print("BND fixture: %d events, BAM %d bytes, built in %.1f s"
                  % (N_BND_EVENTS, os.path.getsize(bnd[0]),
                     time.time() - t0))
    return bam, vcf, truth, bnd


def run_one_card(work: str) -> None:
    import jax

    from bench import run_cli_in_process
    from svtyper_tpu.gt import TpuEngine

    bam, vcf, truth, (bnd_bam, bnd_vcf, bnd_truth) = build_fixtures(
        work, with_bnd=True
    )
    fixtures = {
        "main": (bam, vcf, truth, CONC_FLOOR_MAIN),
        "bnd": (bnd_bam, bnd_vcf, bnd_truth, CONC_FLOOR_BND),
    }
    stats = os.path.join(work, "stats.json")

    def out(name, tag):
        return os.path.join(work, "%s.%s.vcf" % (name, tag))

    def lib_json(name):
        return os.path.join(work, name + ".lib.json")

    def argv(name, tag, *extra):
        b, v = fixtures[name][:2]
        return ["-i", v, "-B", b, "-o", out(name, tag), "-l", lib_json(name),
                *extra]

    with Phase("f32 CLI (shipped default)"):
        for name in fixtures:
            st = run_cli_in_process(argv(name, "f32"), stats)
            _print_cli_stats("f32 CLI %s" % name, st)
        engine = TpuEngine([_load_sample(bam, lib_json("main"))])
        compiled = engine.compile_step(_breakpoints(vcf)[:engine.chunk_size])
        print("engine step at chunk %d: %s"
              % (engine.chunk_size, compiled.memory_analysis()))
        engine.close()

    with Phase("determinism (second f32 CLI run)"):
        for name in fixtures:
            run_cli_in_process(argv(name, "f32b"), stats)
            same_bytes(out(name, "f32"), out(name, "f32b"),
                       "f32 CLI %s, run 1 vs run 2" % name)

    with Phase("oracle parity"):
        for name in fixtures:
            st = run_cli_in_process(
                argv(name, "oracle", "--engine", "oracle"), stats
            )
            print("oracle %s: genotype wall %.3f s"
                  % (name, st["genotype_wall_s"]))
        jax.config.update("jax_enable_x64", True)
        try:
            for name in fixtures:
                st = run_cli_in_process(argv(name, "x64"), stats)
                _print_cli_stats("x64 CLI %s" % name, st)
        finally:
            jax.config.update("jax_enable_x64", False)
        for name, (_b, _v, tr, floor) in fixtures.items():
            same_bytes(out(name, "x64"), out(name, "oracle"),
                       "x64 device vs oracle, %s" % name)
            print("f32 vs oracle, %s: records differing per key %s"
                  % (name, json.dumps(
                      format_key_diffs(out(name, "f32"), out(name, "oracle")),
                      sort_keys=True)))
            ok, n = concordance(out(name, "f32"), tr)
            print("f32 concordance vs simulated truth, %s: %d/%d = %.4f "
                  "(floor %.2f)" % (name, ok, n, ok / n, floor))
            if ok / n < floor:
                raise AssertionError("%s concordance %.4f below %.2f"
                                     % (name, ok / n, floor))

    with Phase("shard_map program on one card"):
        sample = _load_sample(bam, lib_json("main"))
        bps = _breakpoints(vcf)
        gpu0 = jax.devices()[:1]
        with TpuEngine([sample], devices=gpu0) as plain, \
                TpuEngine([sample], devices=gpu0, force_shard=True) as shard:
            rows_p, dt_p = _engine_rows(plain, bps)
            rows_s, dt_s = _engine_rows(shard, bps)
        print("plain engine %.3f s, force-sharded engine %.3f s "
              "(compile included)" % (dt_p, dt_s))
        if render_rows(vcf, sample.name, rows_p) != render_rows(
            vcf, sample.name, rows_s
        ):
            raise AssertionError("force-sharded rows differ from plain")
        print("force-sharded rows byte-identical to plain (%d records)"
              % len(bps))


def run_four_cards(work: str) -> None:
    import jax

    from svtyper_tpu.gt import TpuEngine
    from svtyper_tpu.stats import Sample

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit("--four needs 4 devices, found %d" % len(devices))
    bam, vcf, _truth, _ = build_fixtures(work, with_bnd=False)
    with Phase("four cards vs one card"):
        from svtyper_tpu.bamio.bam import open_bam

        sample = Sample.from_bam(open_bam(bam))
        bps = _breakpoints(vcf)
        rendered, walls = {}, {}
        for n in (4, 1):
            with TpuEngine([sample], devices=devices[:n]) as engine:
                assert engine.n_dev == n and engine.sharded == (n > 1)
                _engine_rows(engine, bps)  # compile, first-touch decode
                rows, walls[n] = _engine_rows(engine, bps)
            rendered[n] = render_rows(vcf, sample.name, rows)
        print("engine wall, warm pass over %d variants: 4 cards %.3f s, "
              "1 card %.3f s" % (len(bps), walls[4], walls[1]))
        if rendered[4] != rendered[1]:
            raise AssertionError("four-card rows differ from one-card rows")
        print("four-card rows byte-identical to one-card rows (%d records)"
              % len(bps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh against one card")
    args = ap.parse_args(argv)
    if not args.four:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import jax

    from svtyper_tpu.bamio import native
    from svtyper_tpu.utils.compile_cache import enable_compile_cache

    backend = jax.default_backend()
    if backend != "gpu":
        print("chip_smoke: JAX's default backend is %r, not a GPU" % backend,
              file=sys.stderr)
        return 2
    with Phase("device and card"):
        print("card: %s" % card_line())
        devices = jax.devices()
        for d in devices:
            print("jax device %d: platform=%s kind=%s"
                  % (d.id, d.platform, d.device_kind))
        print("compile cache: %s" % enable_compile_cache())

    with Phase("native decoder (built from source on first use, set-up)"):
        if native.get_lib() is None:
            raise AssertionError("native BAM decoder did not load")
        print("native decoder loaded: %s" % native._SO)

    work = tempfile.mkdtemp(prefix="svt_chip_smoke_")
    try:
        if args.four:
            run_four_cards(work)
        else:
            run_one_card(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    d0 = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
