"""The Schedule IR, its virtual-rank executor and the α–β cost model."""
