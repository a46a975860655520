"""setup_s: from the start of the run's process to the first timed
read: imports, the database and its packed layout mapped (built in the
first run of a checkout), the classifier made and uploaded, the kernel
libraries loaded (compiled in the first run) and the warm-up.  The
benchmark's own drawing and writing of the timed sample is left out:
a lab's sample exists before it classifies, and its size follows the
program's rate."""


def read(run):
    return run.setup_s
