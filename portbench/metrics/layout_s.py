"""layout_s: seconds of the program's `layout` set-up spans (the LCA
tables and the packed probe layout, mapped from the pack cache or
built), as Classifier.setup_times keeps them."""


def read(run):
    return getattr(run.clf, "setup_times", {}).get("layout")
