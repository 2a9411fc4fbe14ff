"""Batched rigid-body physics of the port: FK, CRBA/RNEA, constraint rows,
the contact solve, the control step in its three modes, and the
differentiable linear algebra (`linalg`) that forward-mode AD through the
per-env path runs."""
