"""em_mappings: (species, score^2) mappings the EM pass reads a query:
the `mappings` run_em returns for each pass of the window (the records
of its mapping file; a pass with no mapping returns None, 0), over the
queries classified in the window.  A program whose run_em returns no
such count, or an entry that runs no EM pass, reads nothing."""


def read(run):
    passes = run.win.get("em")
    if not passes or not run.win["queries"]:
        return None
    if any(p is not None and "mappings" not in p for p in passes):
        return None
    n = sum(p["mappings"] for p in passes if p is not None)
    return n / run.win["queries"]
