"""The torch package's public surface held to the JAX package's.

Both packages' sources are read with ast; neither is imported, so this
runs anywhere.  For each module of metabuli_work_tpu/, every public
top-level function and class, and every public method of a public
class, must have a counterpart of the same name in the mapped module of
metabuli_work_tpu_torch/, and the counterpart must accept each public
parameter name of the JAX one (keyword-only is fine).  A class's
constructor parameters are its __init__'s, or a dataclass's fields.  A
**kwargs that a function passes on whole to another function of its
module accepts what that function accepts.

NOT_CARRIED lists what the port leaves out by design, each entry with
its reason, and nothing else: an entry that no longer excuses a gap
fails too."""

import ast
import os

import pytest

from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "metabuli_work_tpu")
PORT_PKG = os.path.join(REPO, "metabuli_work_tpu_torch")

# names that moved to another module of the port
MOVED = {
    **{("ops/match_jax.py", n): "index/packing.py"
       for n in ("build_aa_hash", "pack_db_quad", "pack_db_rows32")},
    ("parallel/sharding.py", "shard_quad_index"): "index/packing.py",
}

_FLAGSHIP = "models/flagship.py"
_SHARDING = "parallel/sharding.py"
_NARROW = {"aligned", "bucket_lo", "db_aa_lo", "bucket_shift",
           "bucket_steps"}
_ACC = {"acc_sel", "acc_ham", "acc_rh", "acc_tax", "acc_sp", "acc_dna",
        "acc_over"}

# Not carried by design: (reason, {(JAX module, name): parameters}); a
# name of None is the whole module, parameters of None the whole name.
NOT_CARRIED = [
    # JAX's own setup (the x64 switch and the compile cache); torch
    # carries 64-bit integers without a switch
    ("JAX setup", {("ops/_jax_setup.py", None): None}),
    # a jax.profiler trace; the port's maybe_torch_profile (checked
    # below to take the same parameters) writes a torch.profiler trace
    ("renamed: maybe_torch_profile",
     {("utils/timing.py", "maybe_jax_profile"): None}),
    # shares a resident index between two JAX Classifiers; ADVICE.md
    # (round 5) found it crashes under METABULI_HASH_PROBE=0, and the
    # results are the same without it
    ("device_donor (ADVICE.md)",
     {("classify/pipeline.py", "Classifier.from_memory"): {"device_donor"}}),
    # Pallas-only: interpret mode and the choice of the Pallas kernel;
    # the port launches its CUDA kernel for a CUDA tensor and runs the
    # plain version for a CPU one
    ("Pallas switches",
     {("ops/dp_pallas.py", "path_dp_blocked"): {"interpret"},
      (_FLAGSHIP, "finish_stream_step"): {"dp_pallas", "pallas_interpret"},
      (_FLAGSHIP, "fused_step_dp"): {"dp_pallas", "pallas_interpret"},
      (_FLAGSHIP, "fused_step_full"): {"dp_pallas", "pallas_interpret"},
      (_SHARDING, "make_sharded_fused_dp_prod"):
          {"dp_pallas", "pallas_interpret"}}),
    # JAX donates seven accumulator buffers; the port passes them as one
    # dict, `acc` of probe_range_step (folded in place) and `out` of
    # finish_stream_step
    ("accumulators as one dict",
     {(_FLAGSHIP, "probe_range_step"): _ACC,
      (_FLAGSHIP, "finish_stream_step"): _ACC}),
    # static descriptions of a batch that jit compiles a step for; the
    # port reads each from the tensors it is given: `paired` from reads2
    # (lmax2 in part_widths), and in the mesh step factories `has_ra`
    # from ra1, `compact5` and `shapes` from each batch's rows.  Forcing
    # them has no caller-visible effect: JAX's only caller of the
    # factories (Classifier._dispatch_batch_dp_stream_sharded) derives
    # shapes from part_widths of the row widths, as the port's
    # extract_queries_step does, and compact5 as
    # (Bl * 6 < 2**16) and (lmax < 2**14) of the per-row batch Bl and
    # lmax = r1 width (+ r2 width + 3 paired), which is
    # flagship.compact5_fits(Bl, r1 width, r2 width), what the port's
    # extract stage computes for each row
    ("paired and the other batch descriptions",
     {(_FLAGSHIP, "fused_step"): {"paired"},
      (_FLAGSHIP, "extract_queries_step"): {"paired"},
      (_FLAGSHIP, "fused_step_dp"): {"paired"},
      (_FLAGSHIP, "fused_step_full"): {"paired"},
      (_FLAGSHIP, "part_widths"): {"paired"},
      (_SHARDING, "make_sharded_fused_dp_prod"): {"paired", "has_ra"},
      (_SHARDING, "make_sharded_stream_steps"):
          {"paired", "has_ra", "compact5", "shapes"}}),
    # one probe layout on the card: 512-byte rows with the AA hash,
    # resident, streamed and on a mesh.  The JAX package's 64-byte block
    # rows (run starts aligned by align_runs4, which the hash then points
    # into through starts_override, or not), entry-row shards and bucket
    # bisection gave rates that the wide layout's own spread covers on
    # the H100 (-8.4% to +7.5%; METABULI_HASH_CHAIN=3 15.0% slower), and
    # every classification is the same on any of them
    ("one probe layout on the card",
     {("ops/match_jax.py", "pack_db_blocks"): None,
      ("ops/match_jax.py", "align_runs4"): None,
      ("ops/match_jax.py", "build_aa_hash"): {"starts_override"},
      (_SHARDING, "shard_quad_index"): {"wide"},
      ("ops/match_jax.py", "match_kmers_quad"): _NARROW,
      (_FLAGSHIP, "fused_step_dp"): _NARROW,
      (_FLAGSHIP, "fused_step_full"): _NARROW}),
    # JAX accepts it and never reads it
    ("unread", {("parallel/scaling.py", "measure_scaling"): {"n_kmers"}}),
    # no caller in either package sets or reads these.  long_read_chunk
    # widens the JAX native reader's rows above 4096 bases (a longer
    # read is cut there); the port's native batches widen to each read's
    # full length (Classifier._widen), so no width changes a result.
    # want_quals makes the reader return the quality rows as a fourth
    # item, which no scorer of either package reads.  lo_override hands
    # match_kmers_quad precomputed run starts; no function of either
    # package passes it
    ("no caller, no effect on results",
     {("classify/pipeline.py", "ClassifyParams"): {"long_read_chunk"},
      ("io/native_reader.py", "NativeBatchReader"): {"want_quals"},
      ("ops/match_jax.py", "match_kmers_quad"): {"lo_override"}}),
]
RENAMED = {("utils/timing.py", "maybe_jax_profile"): "maybe_torch_profile"}


def _counterpart(rel):
    """The port module of a JAX module (paths relative to the package)."""
    d, f = os.path.split(rel)
    if rel == "ops/dp_pallas.py":
        return "ops/dp_cuda.py"
    if rel == "index/packed_cache.py":
        return "index/packing.py"
    if d == "ops" and f.endswith("_jax.py"):
        return f"ops/{f[:-len('_jax.py')]}_torch.py"
    return rel


def _jax_modules():
    out = []
    for d, _, files in os.walk(JAX_PKG):
        out += [os.path.relpath(os.path.join(d, f), JAX_PKG)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _params(fn):
    """(parameter names, name of the **kwargs or None); the names of
    *args and **kwargs are not parameters a caller names."""
    a = fn.args
    return ([p.arg for p in a.posonlyargs + a.args + a.kwonlyargs],
            a.kwarg.arg if a.kwarg else None)


def _forwarded_to(fn, kwarg):
    """Names of the functions fn calls with **kwarg passed on whole."""
    return {c.func.id for c in ast.walk(fn)
            if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
            and any(k.arg is None and isinstance(k.value, ast.Name)
                    and k.value.id == kwarg for k in c.keywords)}


def _surface(path):
    """{qualified name: (kind, accepted parameter names)} of a module's
    public functions, classes and public methods; kind is "function",
    "class" or "method".  A class's names are its constructor's."""
    tree = ast.parse(open(path).read(), path)
    top = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def accepted(fn, seen=()):
        names, kwarg = _params(fn)
        names = set(names) - {"self", "cls"}
        if kwarg:
            for callee in _forwarded_to(fn, kwarg) - set(seen):
                if callee in top:
                    names |= accepted(top[callee], seen + (fn.name,))
        return names

    out = {}
    for n in tree.body:
        if isinstance(n, ast.FunctionDef) and not n.name.startswith("_"):
            out[n.name] = ("function", accepted(n))
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            fields = {s.target.id for s in n.body
                      if isinstance(s, ast.AnnAssign)
                      and isinstance(s.target, ast.Name)}
            init = [m for m in n.body if isinstance(m, ast.FunctionDef)
                    and m.name == "__init__"]
            out[n.name] = ("class",
                           accepted(init[0]) | fields if init else fields)
            for m in n.body:
                if isinstance(m, ast.FunctionDef) \
                        and not m.name.startswith("_"):
                    out[f"{n.name}.{m.name}"] = ("method", accepted(m))
    return out


_PORT_SURFACES = {}


def _port_surface(rel):
    if rel not in _PORT_SURFACES:
        _PORT_SURFACES[rel] = _surface(os.path.join(PORT_PKG, rel))
    return _PORT_SURFACES[rel]


def _gaps(rel):
    """What a JAX module has and the port lacks: (module, name, None) for
    a missing module (name None) or name, (module, name, parameter) for
    a parameter the counterpart does not accept."""
    port_rel = _counterpart(rel)
    if not os.path.exists(os.path.join(PORT_PKG, port_rel)):
        return {(rel, None, None)}
    gaps = set()
    for name, (_, params) in _surface(os.path.join(JAX_PKG, rel)).items():
        there = _port_surface(MOVED.get((rel, name), port_rel))
        if name not in there:
            gaps.add((rel, name, None))
            continue
        for p in params:
            if not p.startswith("_") and p not in there[name][1]:
                gaps.add((rel, name, p))
    return gaps


def _excused():
    out = set()
    for _, where in NOT_CARRIED:
        for (rel, name), params in where.items():
            out |= {(rel, name, None)} if params is None else \
                {(rel, name, p) for p in params}
    return out


def _describe(gaps):
    return sorted(f"{rel}: {name or '(module)'}"
                  + (f"({p}=)" if p else "") for rel, name, p in gaps)


@pytest.mark.parametrize("rel", _jax_modules())
def test_module_surface_has_its_counterpart(rel):
    missing = _gaps(rel) - _excused()
    assert not missing, \
        f"no counterpart in metabuli_work_tpu_torch: {_describe(missing)}"


def test_not_carried_list_excuses_only_real_gaps():
    """Every entry is still a gap: what the port has since carried
    leaves the list."""
    gaps = set().union(*(_gaps(rel) for rel in _jax_modules()))
    stale = _excused() - gaps
    assert not stale, f"NOT_CARRIED entries the port carries: " \
                      f"{_describe(stale)}"


def test_renamed_counterparts_take_the_same_parameters():
    for (rel, name), new in RENAMED.items():
        old = _surface(os.path.join(JAX_PKG, rel))[name]
        assert _port_surface(_counterpart(rel))[new] == old, (name, new)


def test_module_map_and_moves_point_at_port_modules():
    """Each mapped module and each move target exists, and each moved
    name is defined in the module it moved to."""
    for rel in _jax_modules():
        if (rel, None, None) not in _excused():
            assert os.path.exists(os.path.join(PORT_PKG, _counterpart(rel)))
    for (rel, name), target in MOVED.items():
        assert name in _surface(os.path.join(JAX_PKG, rel))
        assert name in _port_surface(target), (name, target)


def test_surface_reading_sees_forwarded_keywords_and_dataclass_fields(
        tmp_path):
    """The reader's rules on a small module: a **kwargs passed on whole
    accepts the callee's names (and nothing it does not pass on), a
    dataclass's fields are its constructor's names, private names are
    not public surface."""
    src = tmp_path / "m.py"
    src.write_text(
        "from dataclasses import dataclass\n"
        "def inner(a, *, b=1):\n    pass\n"
        "def outer(x, **kw):\n    return inner(x, **kw)\n"
        "def keeps(**kw):\n    return dict(kw)\n"
        "def _private(z):\n    pass\n"
        "@dataclass\nclass P:\n    f: int = 0\n"
        "    def m(self, q):\n        pass\n"
        "    def _h(self):\n        pass\n")
    s = _surface(str(src))
    assert s["outer"] == ("function", {"x", "a", "b"})
    assert s["keeps"] == ("function", set())
    assert s["P"] == ("class", {"f"})
    assert s["P.m"] == ("method", {"q"})
    assert "_private" not in s and "P._h" not in s
