"""Plain float32 PyTorch references of the benchmark's configurations.

They import nothing of the port, of the JAX package or of JAX, and read
only the weights and inputs the benchmark made. ``lowp`` holds the one
precision switch: the same code with every matmul input rounded to
float8 (e4m3) is the control that a sound comparison must fail.
"""
