"""PyTorch/CUDA port of smplsim_tpu for NVIDIA Hopper: batched HumanoidSpeed
stepping through hand-written CUDA kernels (see README, "PyTorch/CUDA port")."""
