"""upload_s: seconds of the program's `upload` set-up span (the packed
index and the taxonomy tables copied to the device), as
Classifier.setup_times keeps them."""


def read(run):
    return getattr(run.clf, "setup_times", {}).get("upload")
