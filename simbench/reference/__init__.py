"""The benchmark's plain reference: a frozen copy of the port's physics
(FK, CRBA/RNEA, constraint and collision rows, the compact contact solve,
the uhc_pd control loop) and of its speed and getup tasks with the
autoreset, in plain PyTorch.

What the copy changes: the plain column forms of Kernels A-E
(ops/linalg.py) and of the QP (ops/qp.py) stand where the port launches
its kernels, the dense route is the only route, the matrix-product
precision is the caller's (physics/precision.py), every size and knob
the port reads from the environment is a constant or an argument, and
random numbers are drawn in the configuration's float32 and widened
(envs/base.py::DRAW_DTYPE), so that a float64 reference draws what the
port draws from the same generator state. Copied docstrings that name a
kernel mean its plain form here.

It imports torch and numpy and nothing of the port or of the JAX package.
"""
