"""roofline.frame4k_x4: roofline.frame of the 4K cell on 4 cards (rank 0's), which moves frame4k_x4_ms."""

from bench_port.spec import reader

read = reader("roofline.frame")
