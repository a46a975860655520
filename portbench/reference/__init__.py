"""The plain reference that decides a run's `correct`.

NumPy and the standard library only: it imports nothing of the program
(`metabuli_work_tpu_torch`), nothing of the JAX package and no JAX.  It
builds its own index from the genomes the harness made, extracts each
read's metamers itself, matches them against that index and scores the
matches with a scalar copy of Metabuli's Taxonomer (`scorer.py`).

`genetic_code.py`, `encode.py` and `scorer.py` are frozen copies of the
port's plain CPU pieces (ops/genetic_code.py, ops/encode_np.py,
classify/taxonomer.py), which mirror the reference C++ line for line;
`classify.py` (index, matcher, per-read classify) and `taxonomy.py` are
written here.
"""
