"""Data layer: dataset loaders (Replica, ScanNet, synthetic), image
transforms, instance association, and host->device prefetching."""
