"""The paper's own workloads: prime sieve + polynomial multiplication.

Not an LM architecture: this config records the stream-program shapes used
by the faithful reproduction (benchmarks/bench_primes.py, bench_polymul.py).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class StreamExampleConfig:
    name: str = "paper-stream"
    primes_limit: int = 20000        # the paper's `primes`
    primes_x3_limit: int = 60000     # the paper's `primes_x3`
    primes_block: int = 256
    primes_per_cell: int = 16
    poly_power: int = 6              # Fateman (1+x+y+z)^k
    poly_limbs_small: int = 4        # `stream`
    poly_limbs_big: int = 12         # `stream_big` (x100000000001)
    poly_terms_per_cell: int = 8
    poly_x_chunks: int = 4


CONFIG = StreamExampleConfig()
