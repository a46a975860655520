"""db_load_s: seconds of the program's `db_load` set-up span (load_index,
or the import of a reference-format DB), as Classifier.setup_times
keeps them."""


def read(run):
    return getattr(run.clf, "setup_times", {}).get("db_load")
