"""The taxonomy tools and the report and grading modules of the torch
package against the JAX package: gtdb_to_taxdump, edit_names,
create_new_taxa_list, query_to_reference, filter_by_genus,
count_common_kmers, make_aa_offset (taxonomy/), and grade, extract,
refine, the benchmark-set makers and stratified graders, mapping2taxon,
ictv_format and make_virus_benchmark_set (report/).  Each case runs the
same call in both packages, each writing into a directory of its own,
and holds them equal: the return value, the printed text, the exception
(type and message) and the bytes of every file written."""

import os
import shutil

import numpy as np
import pytest

import metabuli_work_tpu.report.benchmark as jbench
import metabuli_work_tpu.report.extract as jextract
import metabuli_work_tpu.report.grade as jgrade
import metabuli_work_tpu.report.refiner as jrefiner
import metabuli_work_tpu.report.virus_benchmark as jvirus
import metabuli_work_tpu.taxonomy.gtdb as jgtdb
import metabuli_work_tpu.taxonomy.tools as jtools
import metabuli_work_tpu_torch.report.benchmark as tbench
import metabuli_work_tpu_torch.report.extract as textract
import metabuli_work_tpu_torch.report.grade as tgrade
import metabuli_work_tpu_torch.report.refiner as trefiner
import metabuli_work_tpu_torch.report.virus_benchmark as tvirus
import metabuli_work_tpu_torch.taxonomy.gtdb as tgtdb
import metabuli_work_tpu_torch.taxonomy.tools as ttools
from metabuli_work_tpu_torch.index.builder import build_database

from torch_port_db import write_inputs, write_tool_inputs
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

MODULES = {
    "gtdb": (jgtdb, tgtdb), "tools": (jtools, ttools),
    "grade": (jgrade, tgrade), "extract": (jextract, textract),
    "refiner": (jrefiner, trefiner), "bench": (jbench, tbench),
    "virus": (jvirus, tvirus),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A syncmer DB of write_inputs' genomes, a second DB of two of them,
    and write_tool_inputs' files."""
    root = str(tmp_path_factory.mktemp("tools"))
    genomes, p = write_inputs(root)
    d = {"root": root, **p}
    d["db"] = os.path.join(root, "db")
    build_database(d["db"], p["fastas"], p["acc2taxid"], p["taxdump"],
                   syncmer=True, mask_mode=0)
    sub = os.path.join(root, "sub")
    os.makedirs(sub)
    with open(os.path.join(sub, "g.fna"), "w") as f:
        f.write(f">ACC0\n{genomes[0]}\n>ACC3\n{genomes[3][:2500]}\n")
    with open(os.path.join(sub, "fastas.txt"), "w") as f:
        f.write(os.path.join(sub, "g.fna") + "\n")
    d["db2"] = os.path.join(root, "db2")
    build_database(d["db2"], os.path.join(sub, "fastas.txt"), p["acc2taxid"],
                   p["taxdump"], syncmer=True, mask_mode=0)
    write_tool_inputs(d, genomes)
    # a kmers.npy out of order, with repeats (np.unique's general case)
    d["db_shuffled"] = os.path.join(root, "shuffled")
    os.makedirs(d["db_shuffled"])
    values = np.load(os.path.join(d["db2"], "kmers.npy"))
    np.save(os.path.join(d["db_shuffled"], "kmers.npy"),
            np.random.default_rng(4).permutation(np.concatenate(
                [values, values[::7]])))
    return d


def _out(d, who):
    return os.path.join(d["root"], f"out_{who}")


# case: (module, function, args builder (data, out dir) -> (args, kwargs))
CASES = {
    "gtdb_to_taxdump": ("gtdb", "gtdb_to_taxdump", lambda d, o: (
        ([d["gtdb1"], d["gtdb2"]], f"{o}/taxdump"), {})),
    "gtdb_to_taxdump-start": ("gtdb", "gtdb_to_taxdump", lambda d, o: (
        ([d["gtdb1"]], f"{o}/taxdump2"), {"start_taxid": 500})),
    "edit_names": ("tools", "edit_names", lambda d, o: (
        (d["names"], f"{o}/names.dmp", d["repl"]), {})),
    "edit_names-plain": ("tools", "edit_names", lambda d, o: (
        (d["names"], f"{o}/names_plain.dmp"), {})),
    "create_new_taxa_list": ("tools", "create_new_taxa_list", lambda d, o: (
        (d["fastas_new"], d["acc2taxid_new"], d["taxdump"],
         f"{o}/new_taxa.tsv"), {})),
    "query_to_reference": ("tools", "query_to_reference", lambda d, o: (
        (d["cls_clean"], d["acc2taxid"], f"{o}/q2r.tsv"), {})),
    "query_to_reference-bad-taxid": ("tools", "query_to_reference",
                                     lambda d, o: ((d["cls"], d["acc2taxid"],
                                                    f"{o}/q2r.tsv"), {})),
    "filter_by_genus": ("tools", "filter_by_genus", lambda d, o: (
        (d["cls"], d["db"], [2, 77], f"{o}/genus.tsv"), {})),
    "count_common_kmers": ("tools", "count_common_kmers", lambda d, o: (
        (d["db"], d["db2"]), {})),
    "count_common_kmers-unsorted": ("tools", "count_common_kmers",
                                    lambda d, o: ((d["db_shuffled"], d["db"]),
                                                  {})),
    "count_common_kmers-missing": ("tools", "count_common_kmers",
                                   lambda d, o: ((d["db"], d["root"]), {})),
    "make_aa_offset": ("tools", "make_aa_offset", lambda d, o: (
        (d["db"], f"{o}/aa_offsets.npy"), {})),
    "grade": ("grade", "grade", lambda d, o: (
        (d["cls"], d["answer"], d["db"]), {})),
    "grade-ranks": ("grade", "grade", lambda d, o: (
        (d["cls"], d["answer"], d["taxdump"]), {"ranks": ["genus",
                                                            "species"]})),
    "extract": ("extract", "extract_reads", lambda d, o: (
        (d["cls"], _copy(d["reads_fq"], o), 2, d["db"]), {})),
    "extract-fasta-out": ("extract", "extract_reads", lambda d, o: (
        (d["cls"], _copy(d["reads_fq"], o), 10, d["db"]),
        {"extract_mode": 1})),
    "extract-fastq-out": ("extract", "extract_reads", lambda d, o: (
        (d["cls"], _copy(d["reads_fq"], o), 11, d["db"]),
        {"extract_mode": 2})),
    "extract-fasta-in": ("extract", "extract_reads", lambda d, o: (
        (d["cls"], _copy(d["reads_fa"], o), 3, d["db"]), {})),
    "extract-fasta-to-fastq": ("extract", "extract_reads", lambda d, o: (
        (d["cls"], _copy(d["reads_fa"], o), 3, d["db"]),
        {"extract_mode": 2})),
    "extract-unknown-taxid": ("extract", "extract_reads", lambda d, o: (
        (d["cls"], _copy(d["reads_fq"], o), 99999, d["db"]), {})),
    "refine": ("refiner", "refine", lambda d, o: (
        (d["cls"], d["db"], f"{o}/refined.tsv"), {})),
    "refine-options": ("refiner", "refine", lambda d, o: (
        (d["cls"], d["db"], f"{o}/refined2.tsv"),
        {"min_score": 0.3, "include_taxids": [2, 3],
         "exclude_taxids": [11], "rank": "genus"})),
    "make_test_sets": ("bench", "make_test_sets", lambda d, o: (
        (d["assemblies"], d["db"], f"{o}/sets"), {})),
    "make_test_sets-genus": ("bench", "make_test_sets", lambda d, o: (
        (d["assemblies"], d["taxdump"], f"{o}/sets2"),
        {"rank": "genus", "exclude_per_rank": 2, "seed": 7})),
    "make_inclusion_queries": ("bench", "make_inclusion_queries",
                               lambda d, o: ((d["assemblies"],
                                              f"{o}/incl"),
                                             {"fraction": 0.5, "seed": 3})),
    "grade_by_strata": ("bench", "grade_by_strata", lambda d, o: (
        (d["cls"], d["answer"], d["db"], d["strata"]),
        {"ranks": ["species", "genus"], "label": "coverage"})),
    "grade_group": ("bench", "grade_group", lambda d, o: (
        (d["groups"], d["answer"], d["db"]), {})),
    "grade_group_by_strata": ("bench", "grade_group_by_strata",
                              lambda d, o: ((d["groups"], d["answer"],
                                             d["db"], d["strata"]),
                                            {"ranks": ["species"]})),
    "mapping2taxon": ("bench", "mapping2taxon", lambda d, o: (
        (d["mapping"], d["db"], f"{o}/m2t.tsv"), {"rank": "genus"})),
    "ictv_format": ("virus", "ictv_format", lambda d, o: (
        (d["ictv"], f"{o}/ictv"), {})),
    "ictv_format-no-ranks": ("virus", "ictv_format", lambda d, o: (
        (d["assemblies"], f"{o}/ictv_bad"), {})),
    "make_virus_benchmark_set": ("virus", "make_virus_benchmark_set",
                                 lambda d, o: ((d["assemblies"], d["db"],
                                                f"{o}/virus"),
                                               {"rank": "species"})),
}


def _copy(path, out):
    os.makedirs(out, exist_ok=True)
    return shutil.copy(path, out)


def _canon(x, o):
    """A comparable form of a return value: paths relative to the
    package's output directory, arrays as lists."""
    if isinstance(x, str):
        return x.replace(o, "OUT")
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, dict):
        return {k: _canon(v, o) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v, o) for v in x]
    return x


def _files(o):
    out = {}
    for dirpath, _, names in os.walk(o):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, o)] = f.read()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_tool_equals_jax(data, capsys, case):
    mod, fn, make = CASES[case]
    got = {}
    for who, m in zip("jt", MODULES[mod]):
        o = os.path.join(_out(data, who), case)
        os.makedirs(o, exist_ok=True)
        args, kw = make(data, o)
        capsys.readouterr()
        try:
            ret, err = getattr(m, fn)(*args, **kw), None
        except (SystemExit, FileNotFoundError, ValueError) as e:
            ret, err = None, (type(e).__name__, str(e).replace(o, "OUT"))
        text = capsys.readouterr().out.replace(o, "OUT")
        got[who] = (_canon(ret, o), err, text, _files(o))
    assert got["t"] == got["j"]
    ret, err, text, files = got["t"]
    assert err is not None or text
    if case in ("extract-fasta-to-fastq", "extract-unknown-taxid",
                "count_common_kmers-missing", "ictv_format-no-ranks",
                "query_to_reference-bad-taxid"):
        assert err is not None
    elif not case.startswith(("count_common", "grade")):
        assert any(files.values()), "no output written"
