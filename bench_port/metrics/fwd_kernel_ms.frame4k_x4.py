"""fwd_kernel_ms.frame4k_x4: fwd_kernel_ms.frame of the 4K cell on 4 cards (rank 0's), which moves frame4k_x4_ms."""

from bench_port.spec import reader

read = reader("fwd_kernel_ms.frame")
