"""The Schedule IR, its virtual-rank executor, the α–β cost model and the rack
substrate: fabric, rack and pod, the schedule pricer, placement, allocators."""
