"""The torch package's CLI against the JAX package's: the database
subcommands (convertDB, validatedb, database-report, printDeltaIdx,
printInfo, expand_diffidx) and validate-input print the same text and
exit with the same code on the same DB; build --reference-format writes
the same files; classify accepts the JAX-only flags (its files equal
JAX's on a reference-format DB, --em and --validate-input included),
refuses --reduced-aa 1, and --profile-dir writes a torch.profiler trace
on the CPU."""

import os
import shutil

import numpy as np
import pytest

from metabuli_work_tpu import cli as jcli
from metabuli_work_tpu_torch import cli as tcli
from metabuli_work_tpu_torch.index.format import load_index

from torch_port_db import simulate_reads, write_inputs, write_taxonomy_blob


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Each CLI's build --reference-format of one input; reference-only
    twins (diffIdx/info/split, db.parameters, a taxonomyDB blob, no
    db.meta.json) of the torch build, one a package; FASTQ reads."""
    root = str(tmp_path_factory.mktemp("cli"))
    genomes, p = write_inputs(root)
    dirs = {"taxdump": p["taxdump"]}
    for name, cli in (("jdb", jcli), ("tdb", tcli)):
        dirs[name] = os.path.join(root, name)
        assert cli.main(["build", dirs[name], p["fastas"], p["acc2taxid"],
                         "--taxonomy-dir", p["taxdump"], "--syncmer", "1",
                         "--mask", "0", "--reference-format"]) == 0
    tax = load_index(dirs["tdb"]).taxonomy
    for who in ("j", "t"):
        d = dirs[f"{who}ref"] = os.path.join(root, f"{who}ref")
        os.makedirs(d)
        for f in ("diffIdx", "info", "split", "db.parameters"):
            shutil.copy(os.path.join(dirs["tdb"], f), d)
        write_taxonomy_blob(os.path.join(d, "taxonomyDB"), tax)
    broken = dirs["broken"] = os.path.join(root, "broken")
    shutil.copytree(dirs["tdb"], broken)
    with open(os.path.join(broken, "info"), "r+b") as f:
        f.truncate(os.path.getsize(os.path.join(broken, "info")) - 4)
    reads, _ = simulate_reads(genomes, 20, seed=41)
    dirs["reads"] = os.path.join(root, "reads.fq")
    with open(dirs["reads"], "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r.tobytes().decode()}\n+\n{'I' * len(r)}\n")
    dirs["bad"] = os.path.join(root, "bad.fq")
    with open(dirs["bad"], "w") as f:
        f.write("@r1\nACGT\n+\nIII\n")
    return root, dirs


def test_build_reference_format_files_equal_jax(dbs):
    _, dirs = dbs
    for f in ("diffIdx", "info", "split", "kmers.npy", "infos.npy",
              "species.npy", "taxID_list", "acc2taxid.map"):
        with open(os.path.join(dirs["jdb"], f), "rb") as a, \
                open(os.path.join(dirs["tdb"], f), "rb") as b:
            assert a.read() == b.read(), f


def _run(cli, argv, capsys):
    capsys.readouterr()
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# (case, argv; "{jt}" is j for the JAX run and t for the torch run, so a
# command that writes into its DB directory gets a twin of its own)
SUBCOMMANDS = [
    ("validatedb-native", ["validatedb", "{tdb}"]),
    ("validatedb-reference-only", ["validatedb", "{tref}"]),
    ("validatedb-mismatch", ["validatedb", "{broken}"]),
    ("validatedb-missing", ["validatedb", "{root}/nowhere"]),
    ("database-report-native", ["database-report", "{tdb}"]),
    ("database-report-reference", ["database-report", "{jtref}"]),
    ("printDeltaIdx-limit", ["printDeltaIdx", "{tdb}", "--limit", "5"]),
    ("printDeltaIdx-all", ["printDeltaIdx", "{tdb}", "--limit", "0"]),
    ("printInfo", ["printInfo", "{tdb}", "--limit", "7"]),
    ("expand_diffidx", ["expand_diffidx", "{tdb}/diffIdx", "--output",
                        "{root}/{jt}.expanded"]),
    ("convertDB", ["convertDB", "{jtref}", "--taxonomy-dir", "{taxdump}",
                   "--output", "{root}/{jt}conv"]),
    ("validate-input-ok", ["validate-input", "{reads}"]),
    ("validate-input-bad", ["validate-input", "{bad}"]),
]


@pytest.mark.parametrize("case,argv", SUBCOMMANDS,
                         ids=[c for c, _ in SUBCOMMANDS])
def test_subcommand_output_equals_jax(dbs, capsys, case, argv):
    root, dirs = dbs
    got = {}
    for jt, cli in (("j", jcli), ("t", tcli)):
        fill = {**dirs, "root": root, "jt": jt,
                "jtref": dirs[f"{jt}ref"]}
        rc, out, _ = _run(cli, [a.format(**fill) for a in argv], capsys)
        got[jt] = (rc, out.replace(f"{root}/{jt}", "{root}/")
                   .replace(f"{jt}ref", "ref"))
    assert got["t"] == got["j"]
    rc, out = got["t"]
    assert out
    assert rc == (1 if case in ("validatedb-reference-only",
                                "validatedb-mismatch", "validatedb-missing",
                                "validate-input-bad") else 0)
    if case == "expand_diffidx":
        with open(f"{root}/j.expanded", "rb") as a, \
                open(f"{root}/t.expanded", "rb") as b:
            assert a.read() == b.read()
    if case == "convertDB":
        for f in ("kmers.npy", "infos.npy", "species.npy", "taxID_list"):
            with open(f"{root}/jconv/{f}", "rb") as a, \
                    open(f"{root}/tconv/{f}", "rb") as b:
                assert a.read() == b.read(), f
        conv = load_index(f"{root}/tconv")
        np.testing.assert_array_equal(conv.values,
                                      load_index(dirs["tdb"]).values)
        # db.parameters carried into the meta (the JAX convertDB drops
        # it: its converted syncmer DB reads as a 6-frame one)
        assert conv.meta["syncmer"] is True
        assert "syncmer" not in load_index(f"{root}/jconv").meta


def test_convert_db_reads_the_taxonomy_blob(dbs, capsys):
    """Without --taxonomy-dir, convertDB takes the reference DB's own
    taxonomyDB blob (the JAX CLI looks for a taxdump there and fails);
    the converted DB classifies as the native one."""
    root, dirs = dbs
    src = os.path.join(root, "blobref")
    shutil.copytree(dirs["tref"], src,
                    ignore=shutil.ignore_patterns(".import_cache"))
    rc, out, _ = _run(tcli, ["convertDB", src, "--output",
                             os.path.join(root, "blobconv")], capsys)
    assert rc == 0 and out.startswith("convertDB: ")
    with pytest.raises(FileNotFoundError):
        jcli.main(["convertDB", src, "--output",
                   os.path.join(root, "jblobconv")])
    conv, native = load_index(os.path.join(root, "blobconv")), \
        load_index(dirs["tdb"])
    for k in ("values", "taxids", "species"):
        np.testing.assert_array_equal(getattr(conv, k), getattr(native, k))
    np.testing.assert_array_equal(conv.taxonomy.parent,
                                  native.taxonomy.parent)
    outs = {}
    for name in ("blobconv", "tdb"):
        d = dirs.get(name, os.path.join(root, name))
        assert tcli.main(["classify", dirs["reads"], d,
                          os.path.join(root, f"out_{name}"), "job",
                          "--seq-mode", "1", "--batch-size", "8",
                          "--device", "cpu"]) == 0
        with open(os.path.join(root, f"out_{name}",
                               "job_classifications.tsv"), "rb") as f:
            outs[name] = f.read()
    assert outs["blobconv"] == outs["tdb"]


def test_classify_flags_em_validate_and_profile(dbs, capsys):
    """One classify with every flag the JAX CLI accepts and the port
    ignores, on the reference-only DB: the classification and EM files
    equal JAX's; --profile-dir leaves a trace on the CPU."""
    root, dirs = dbs
    flags = ["--seq-mode", "1", "--em", "--validate-input", "--threads",
             "8", "--max-ram", "64", "--hamming-margin", "0",
             "--match-per-kmer", "4", "--batch-size", "8", "--min-score",
             "0.15"]
    trace = os.path.join(root, "trace")
    outs = {jt: os.path.join(root, f"{jt}out") for jt in "jt"}
    rc_j, out_j, _ = _run(jcli, ["classify", dirs["reads"], dirs["jref"],
                                 outs["j"], "job", *flags, "--devices", "1"],
                          capsys)
    rc_t, out_t, _ = _run(tcli, ["classify", dirs["reads"], dirs["tref"],
                                 outs["t"], "job", *flags, "--device", "cpu",
                                 "--profile-dir", trace], capsys)
    assert rc_j == rc_t == 0
    assert f"validate {dirs['reads']}: OK (20 records)" in out_t
    for suffix in ("_classifications.tsv", "_report.tsv",
                   "_mapping_results.txt", "_EM_report.tsv",
                   "_EM+reclassify_results.tsv"):
        with open(os.path.join(outs["j"], "job" + suffix), "rb") as a, \
                open(os.path.join(outs["t"], "job" + suffix), "rb") as b:
            ref = a.read()
            assert b.read() == ref and ref, suffix
    traces = [f for f in os.listdir(trace) if f.endswith(".json")]
    assert len(traces) == 1
    assert os.path.getsize(os.path.join(trace, traces[0])) > 1000


def test_classify_refusals_equal_jax(dbs, capsys):
    """--reduced-aa 1 and an invalid read file under --validate-input
    end with exit code 1 and JAX's messages."""
    root, dirs = dbs
    for extra, reads in ((["--reduced-aa", "1"], dirs["reads"]),
                         (["--validate-input"], dirs["bad"])):
        got = {}
        for jt, cli in (("j", jcli), ("t", tcli)):
            argv = ["classify", reads, dirs["tdb"],
                    os.path.join(root, "refused"), "job", "--seq-mode", "1",
                    *extra] + (["--devices", "1"] if jt == "j"
                               else ["--device", "cpu"])
            got[jt] = _run(cli, argv, capsys)
        assert got["t"] == got["j"]
        assert got["t"][0] == 1 and (got["t"][1] or got["t"][2])
    assert not os.path.exists(os.path.join(root, "refused"))
