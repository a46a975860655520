"""The torch package's CLI against the JAX package's: every subcommand
of the port but classify (the database subcommands, build with its
flags, updateDB, filter, taxdump, databases, the taxonomy tools and the
report and grading tools) prints the same text, exits with the same code
and writes the same files as JAX's on the same inputs; build
--reference-format writes the same files; classify accepts the JAX-only
flags (its files equal JAX's on a reference-format DB, --em and
--validate-input included), refuses --reduced-aa 1, and --profile-dir
writes a torch.profiler trace on the CPU; `databases` downloads and
unpacks an archive from a local HTTP server, resuming a part file."""

import io
import os
import re
import shutil
import tarfile
import threading

import numpy as np
import pytest

from metabuli_work_tpu import cli as jcli
from metabuli_work_tpu_torch import cli as tcli
from metabuli_work_tpu_torch.index.format import load_index

from torch_port_db import (gene_genome, simulate_reads, write_inputs,
                           write_taxonomy_blob, write_tool_inputs)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)


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
    dirs.update(fastas=p["fastas"], acc2taxid=p["acc2taxid"])
    # the tools' inputs, under tools/ (as T_<name>), over the torch DB
    tools = {"root": os.path.join(root, "tools"), "db": dirs["tdb"]}
    os.makedirs(tools["root"])
    write_tool_inputs(tools, genomes)
    dirs.update({f"T_{k}": v for k, v in tools.items()})
    for who in "jt":     # extract writes beside its read file
        shutil.copy(tools["reads_fq"], os.path.join(root, f"{who}_reads.fq"))
    with open(os.path.join(root, "contam.txt"), "w") as f:
        f.write(dirs["tdb"] + "\n")
    dirs["contam"] = os.path.join(root, "contam.txt")
    # build flags: CDS spans, and a new genome with a new species for
    # updateDB --new-taxa
    dirs["cds"] = os.path.join(root, "cds.tsv")
    with open(dirs["cds"], "w") as f:
        f.write("ACC0\t10\t900\t+\nACC2\t300\t1700\t-\n")
    new = gene_genome(np.random.default_rng(44), 4000)
    with open(os.path.join(root, "new.fna"), "w") as f:
        f.write(f">NEW1.1\n{new}\n")
    dirs["new_fastas"] = os.path.join(root, "new.txt")
    with open(dirs["new_fastas"], "w") as f:
        f.write(os.path.join(root, "new.fna") + "\n")
    dirs["new_map"] = os.path.join(root, "new.map")
    with open(dirs["new_map"], "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n"
                "NEW1\tNEW1.1\t20\t0\n")
    dirs["new_taxa"] = os.path.join(root, "new_taxa.tsv")
    with open(dirs["new_taxa"], "w") as f:
        f.write("20\t3\tspecies\tSp20\n")
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
    ("build-orf-cds-accession", [
        "build", "{root}/{jt}orfdb", "{fastas}", "{acc2taxid}",
        "--taxonomy-dir", "{taxdump}", "--syncmer", "1", "--mask", "0",
        "--orf-prediction", "--gene-predictor", "heuristic", "--cds-info",
        "{cds}", "--accession-level", "1"]),
    ("build-auto-resume", [
        "build", "{root}/{jt}autodb", "{fastas}", "{acc2taxid}",
        "--taxonomy-dir", "{taxdump}", "--mask", "0", "--orf-prediction",
        "--resume"]),
    ("updateDB", ["updateDB", "{root}/{jt}upd", "{tdb}", "{new_fastas}",
                  "{new_map}", "--new-taxa", "{new_taxa}"]),
    ("updateDB-unknown-taxon", ["updateDB", "{root}/{jt}upd0", "{tdb}",
                                "{new_fastas}", "{new_map}"]),
    ("filter", ["filter", "{T_reads_fq}", "{root}/{jt}filter", "job",
                "--contam-list", "{contam}", "--seq-mode", "1",
                "--min-score", "0.15", "--batch-size", "8",
                "--device=cpu"]),
    ("taxdump", ["taxdump", "{tdb}", "{root}/{jt}taxdump"]),
    ("databases-list", ["databases"]),
    ("databases-unknown", ["databases", "nope", "{root}/{jt}nodb"]),
    ("extract", ["extract", "{T_cls}", "{root}/{jt}_reads.fq", "{tdb}",
                 "--tax-id", "2"]),
    ("extract-fasta", ["extract", "{T_cls}", "{root}/{jt}_reads.fq",
                       "{tdb}", "--tax-id", "11", "--extract-mode", "1"]),
    ("grade", ["grade", "{T_cls}", "{T_answer}", "{tdb}"]),
    ("grade-ranks", ["grade", "{T_cls}", "{T_answer}", "{tdb}", "--ranks",
                     "genus,species"]),
    ("classifiedRefiner", ["classifiedRefiner", "{T_cls}", "{tdb}",
                           "--output", "{root}/{jt}refined.tsv",
                           "--min-score", "0.2", "--include", "2,3",
                           "--exclude", "13", "--rank", "genus"]),
    ("ictv-format", ["ictv-format", "{T_ictv}", "{root}/{jt}ictv"]),
    ("make-virus-benchmark-set", [
        "make-virus-benchmark-set", "{T_assemblies}", "{tdb}",
        "{root}/{jt}virus", "--rank", "species", "--random-seed", "3"]),
    ("gtdb2taxdump", ["gtdb2taxdump", "{T_gtdb1}", "{T_gtdb2}", "--outdir",
                      "{root}/{jt}gtdb", "--start-taxid", "700"]),
    ("editNames", ["editNames", "{T_names}", "{root}/{jt}names.dmp",
                   "--replacements", "{T_repl}"]),
    ("createnewtaxalist", ["createnewtaxalist", "{T_fastas_new}",
                           "{T_acc2taxid_new}", "{root}/{jt}newtaxa.tsv",
                           "--taxonomy-dir", "{taxdump}"]),
    ("query2reference", ["query2reference", "{T_cls_clean}", "{acc2taxid}",
                         "{root}/{jt}q2r.tsv"]),
    ("filter_by_genus", ["filter_by_genus", "{T_cls}", "{tdb}",
                         "{root}/{jt}genus.tsv", "--genera", "2,3"]),
    ("count-common-kmers", ["count-common-kmers", "{tdb}", "{T_db}"]),
    ("makeAAoffset", ["makeAAoffset", "{tdb}", "--output",
                      "{root}/{jt}aa.npy"]),
    ("maketestsets", ["maketestsets", "{T_assemblies}", "{tdb}",
                      "{root}/{jt}sets", "--rank", "species"]),
    ("makeInclusionTestQueries", ["makeInclusionTestQueries",
                                  "{T_assemblies}", "{root}/{jt}incl",
                                  "--fraction", "0.5"]),
    ("gradeGroup", ["gradeGroup", "{T_groups}", "{T_answer}", "{tdb}"]),
    ("gradeGroupByCoverage", ["gradeGroupByCoverage", "{T_groups}",
                              "{T_answer}", "{tdb}", "{T_strata}"]),
    ("gradeByCoverage", ["gradeByCoverage", "{T_cls}", "{T_answer}",
                         "{tdb}", "{T_strata}"]),
    ("gradeByCladeSize", ["gradeByCladeSize", "{T_cls}", "{T_answer}",
                          "{tdb}", "{T_strata}", "--ranks", "species"]),
    ("mapping2taxon", ["mapping2taxon", "{T_mapping}", "{tdb}",
                       "{root}/{jt}m2t.tsv", "--rank", "genus"]),
    ("accession2taxid", ["accession2taxid", "{fastas}", "{root}/{jt}a2t.map",
                         "--mappings", "{acc2taxid}", "{T_acc2taxid_new}"]),
]

# files (and directories, every file under them) each case writes; each
# is held byte-equal between the two CLIs' runs
WRITES = {
    "build-orf-cds-accession": ["orfdb/kmers.npy", "orfdb/infos.npy",
                                "orfdb/species.npy", "orfdb/acc2taxid.map",
                                "orfdb/accession2index"],
    "build-auto-resume": ["autodb/kmers.npy", "autodb/infos.npy"],
    "updateDB": ["upd/kmers.npy", "upd/infos.npy", "upd/species.npy",
                 "upd/acc2taxid.map", "upd/taxID_list"],
    "filter": ["filter"],
    "taxdump": ["taxdump"],
    "extract": ["_reads_2.fq"],
    "extract-fasta": ["_reads_11.fna"],
    "classifiedRefiner": ["refined.tsv"],
    "ictv-format": ["ictv"],
    "make-virus-benchmark-set": ["virus"],
    "gtdb2taxdump": ["gtdb"],
    "editNames": ["names.dmp"],
    "createnewtaxalist": ["newtaxa.tsv"],
    "query2reference": ["q2r.tsv"],
    "filter_by_genus": ["genus.tsv"],
    "makeAAoffset": ["aa.npy"],
    "maketestsets": ["sets"],
    "makeInclusionTestQueries": ["incl"],
    "mapping2taxon": ["m2t.tsv"],
    "accession2taxid": ["a2t.map"],
}

# cases that end with exit code 1
FAILS = {"validatedb-reference-only", "validatedb-mismatch",
         "validatedb-missing", "validate-input-bad", "databases-unknown"}


def _tree(path):
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return {"": f.read()}
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), path)] = f.read()
    assert out, path
    return out


@pytest.mark.parametrize("case,argv", SUBCOMMANDS,
                         ids=[c for c, _ in SUBCOMMANDS])
def test_subcommand_output_equals_jax(dbs, capsys, case, argv):
    root, dirs = dbs
    got = {}
    for jt, cli in (("j", jcli), ("t", tcli)):
        fill = {**dirs, "root": root, "jt": jt,
                "jtref": dirs[f"{jt}ref"]}
        # --device is the port's own flag (the JAX CLI has none)
        args = [a.format(**fill) for a in argv
                if not (jt == "j" and a == "--device=cpu")]
        rc, out, _ = _run(cli, args, capsys)
        out = re.sub(r"\(\d+\.\d+s\)", "(s)", out)       # build seconds
        out = re.sub(r"in \d+\.\d+s \(\d+ reads/s\)", "in (s)", out)
        got[jt] = (rc, out.replace(f"{root}/{jt}", "{root}/")
                   .replace(f"{jt}ref", "ref")
                   .replace("metabuli-tpu", "metabuli-torch"))
    assert got["t"] == got["j"]
    rc, out = got["t"]
    assert out
    assert rc == (1 if case in FAILS else 0)
    for w in WRITES.get(case, ()):
        assert _tree(f"{root}/t{w}") == _tree(f"{root}/j{w}"), w
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


@pytest.fixture
def http_archive(tmp_path):
    """A local HTTP server (localhost, Range support) serving a small
    reference-format archive under the download host's archive name."""
    import http.server

    serve = tmp_path / "serve"
    serve.mkdir()
    payload = {"diffIdx": np.random.default_rng(0).integers(
        0, 255, size=200_000, dtype=np.uint8).tobytes(),
        "db.parameters": b"Syncmer\t0\n"}
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name, data in payload.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    (serve / "refseq_virus.tar.gz").write_bytes(buf.getvalue())
    starts = []         # the first byte each GET was answered from

    class Handler(http.server.BaseHTTPRequestHandler):
        """GET of a served file; "Range: bytes=N-" answers 206 with the
        tail from N."""

        def do_GET(self):
            path = serve / self.path.lstrip("/")
            if not path.is_file():
                self.send_error(404)
                return
            data = path.read_bytes()
            start = 0
            rng = self.headers.get("Range", "")
            if rng.startswith("bytes="):
                start = int(rng[6:].split("-")[0])
            starts.append(start)
            self.send_response(206 if start else 200)
            self.send_header("Content-Length", str(len(data) - start))
            self.end_headers()
            self.wfile.write(data[start:])

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield (f"http://127.0.0.1:{srv.server_address[1]}", buf.getvalue(),
           payload, starts)
    srv.shutdown()
    t.join(timeout=10)
    assert not t.is_alive()


def test_databases_download_equals_jax(tmp_path, http_archive, monkeypatch,
                                       capsys):
    """`databases RefSeq_virus OUT --tmp TMP` against the local server
    (the download host's URL rewritten to it in both CLIs): the archive
    is fetched, unpacked into OUT and reported as JAX reports it; a part
    file left by an interrupted download is resumed from its offset; an
    unreachable host ends with exit 1 and the instructions."""
    base, blob, payload, starts = http_archive
    host = "https://metabuli.steineggerlab.workers.dev"
    got = {}
    for jt, cli in (("j", jcli), ("t", tcli)):
        real = cli._download_resumable
        monkeypatch.setattr(cli, "_download_resumable",
                            lambda url, dest, timeout=30, real=real:
                            real(url.replace(host, base), dest, timeout))
        out, tmp = tmp_path / f"{jt}out", tmp_path / f"{jt}tmp"
        rc, text, _ = _run(cli, ["databases", "RefSeq_virus", str(out),
                                 "--tmp", str(tmp)], capsys)
        got[jt] = (rc, text.replace(str(tmp_path / jt), "X")
                   .replace("metabuli-tpu", "metabuli-torch"))
        for name, data in payload.items():
            assert (out / name).read_bytes() == data
        assert not (tmp / "refseq_virus.tar.gz.part").exists()
    assert got["t"] == got["j"]
    assert got["t"][0] == 0 and "Extracting into" in got["t"][1]
    # resume: half the archive already in the part file
    dest = tmp_path / "resumed.tar.gz"
    (tmp_path / "resumed.tar.gz.part").write_bytes(blob[:len(blob) // 2])
    capsys.readouterr()
    monkeypatch.undo()
    tcli._download_resumable(f"{base}/refseq_virus.tar.gz", str(dest))
    assert f"resuming at {len(blob) // 2 / 1e6:.1f} MB" in \
        capsys.readouterr().out
    assert dest.read_bytes() == blob
    assert starts == [0, 0, len(blob) // 2]

    def unreachable(url, dest, timeout=30):
        raise OSError("no route to host")

    for jt, cli in (("j", jcli), ("t", tcli)):
        monkeypatch.setattr(cli, "_download_resumable", unreachable)
        rc, text, _ = _run(cli, ["databases", "GTDB",
                                 str(tmp_path / f"{jt}gtdb")], capsys)
        got[jt] = (rc, text.replace(f"{jt}gtdb", "gtdb")
                   .replace("metabuli-tpu", "metabuli-torch"))
    assert got["t"] == got["j"]
    assert got["t"][0] == 1 and "Download failed" in got["t"][1]
