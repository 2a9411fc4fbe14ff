"""Batched rigid-body physics of the port: FK, CRBA/RNEA, constraint rows,
the contact solve and the uhc_pd control step."""
