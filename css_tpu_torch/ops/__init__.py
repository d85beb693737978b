"""Kernels and DSP ops: STFT/iSTFT, features, the CUDA kernels K1/K3."""
