"""host_ms.frame4k: host_ms.frame of the 4K cell on one card, which moves frame4k_ms."""

from bench_port.spec import reader

read = reader("host_ms.frame")
