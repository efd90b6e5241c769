"""Dataset dispatch + background prefetch.

Counterpart of dataset.init_loader (dataset.py:39-61): picks the dataset by
``cfg.dataset_format`` and wraps it in a prefetching iterator. Instead of
torch DataLoader worker processes, a single background thread decodes the
next frames while the device trains the current one (the per-frame decode is
a few ms of image decoding; one thread fully hides it behind the training step).
"""

from __future__ import annotations

import queue
import threading


def make_dataset(cfg):
    fmt = cfg.dataset_format
    if fmt == "Replica":
        from vmap_tpu_torch.data.replica import ReplicaDataset
        return ReplicaDataset(cfg)
    if fmt == "ScanNet":
        from vmap_tpu_torch.data.scannet import ScanNetDataset
        return ScanNetDataset(cfg)
    if fmt == "Synthetic":
        from vmap_tpu_torch.data.synthetic import SyntheticScene
        return _SyntheticAdapter(cfg)
    raise ValueError(f"Dataset format {fmt} not found")


class _SyntheticAdapter:
    """Analytic scene as a dataset (tests/demo without downloads)."""

    def __init__(self, cfg, n_frames: int = 200):
        from vmap_tpu_torch.data.synthetic import SyntheticScene
        self.scene = SyntheticScene(
            width=cfg.W, height=cfg.H, fx=cfg.fx, fy=cfg.fy)
        self.n = n_frames
        self.imap_mode = cfg.imap_mode

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        s = self.scene.frame_sample(idx, n_frames=64)
        if self.imap_mode:
            import numpy as np
            s["obj"] = np.zeros_like(s["obj"])
            s["bbox_dict"] = {0: s["bbox_dict"][0]}
        return s


class PrefetchIterator:
    """Iterate a dataset with a decode-ahead thread (depth 2)."""

    _SENTINEL = object()

    def __init__(self, dataset, depth: int = 2):
        self.dataset = dataset
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for i in range(len(self.dataset)):
                self.q.put(self.dataset[i])
        except Exception as e:  # surface decode errors on the consumer side
            self.q.put(e)
        finally:
            self.q.put(self._SENTINEL)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._SENTINEL:
                return
            if isinstance(item, Exception):
                raise item
            yield item
