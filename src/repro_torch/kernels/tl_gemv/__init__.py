"""Table-lookup ternary GEMV, matmul and fused SwiGLU (CUDA kernels and
plain versions)."""
