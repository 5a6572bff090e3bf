"""The part of the rack simulator's vocabulary that the sharding policy needs."""
