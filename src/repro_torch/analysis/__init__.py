"""Plan-integrity analysis for the port, copied from the JAX package's
``analysis``: the verifier passes the planner hooks call (:mod:`.verify`)
and the static rate-stability prover (:mod:`.prove`).  Both are numpy
only and are imported lazily by the planner, as in the reference."""
