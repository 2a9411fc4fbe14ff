"""The benchmark's plain learner: the PPO update of SMPLSim's default
learning configuration (data/cfg/learning/simple_mlp.yaml), written out in
plain PyTorch, to hold the port's learner against.

`ppo.py` has the MLP with its gradient taken by hand, the diagonal
Gaussian's log-probability, GAE, the running observation norm, the
advantage normalisation, the clipped surrogate, the squared-error value
loss, the global-norm clip and Adam, each as a few lines of tensor
arithmetic, with no torch.nn, torch.optim or autograd. It runs in the
dtype of its inputs (float64 for the check, float32 for the
lower-precision control) at the matrix-product precision its caller
names (full precision for the check, TF32 for the control). It imports
torch and nothing of the port or of the JAX package.
"""
