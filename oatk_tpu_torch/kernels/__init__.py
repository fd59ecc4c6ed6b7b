from .hashes import hash64_np, murmur64_np, MURMUR_SEED
from .oracle import syncmers_of_read_oracle, hoco_compress_np
