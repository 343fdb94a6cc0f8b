"""Training logger. Counterpart of anatomask_tpu/training/logger.py (nnU-Net's
dict-of-lists logger: losses, pseudo-Dice with its EMA at 0.9, LRs, epoch
timestamps; carried in the checkpoints' metadata; progress.png, skipped
without matplotlib)."""
from __future__ import annotations

import os


class TrainingLogger:
    def __init__(self):
        self.logging = {
            "mean_fg_dice": [],
            "ema_fg_dice": [],
            "dice_per_class_or_region": [],
            "train_losses": [],
            "val_losses": [],
            "lrs": [],
            "epoch_start_timestamps": [],
            "epoch_end_timestamps": [],
        }

    def log(self, key: str, value, epoch: int):
        assert key in self.logging, f"unknown log key {key}"
        lst = self.logging[key]
        while len(lst) <= epoch:
            lst.append(None)
        lst[epoch] = value
        if key == "mean_fg_dice":
            ema = self.logging["ema_fg_dice"]
            prev = ema[epoch - 1] if epoch > 0 and len(ema) >= epoch else None
            self.log("ema_fg_dice", value if prev is None else prev * 0.9 + 0.1 * value, epoch)

    def get_checkpoint(self) -> dict:
        return self.logging

    def load_checkpoint(self, checkpoint: dict):
        self.logging = checkpoint

    def plot_progress_png(self, output_folder: str):
        epochs = len(self.logging["train_losses"])
        if epochs == 0:
            return
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        x = list(range(epochs))
        fig, axes = plt.subplots(3, 1, figsize=(10, 12), sharex=True)
        axes[0].plot(x, self.logging["train_losses"], label="train loss")
        if any(v is not None for v in self.logging["val_losses"]):
            axes[0].plot(x, self.logging["val_losses"], label="val loss")
        axes[0].legend()
        axes[0].set_ylabel("loss")
        if any(v is not None for v in self.logging["mean_fg_dice"]):
            axes[1].plot(x, self.logging["mean_fg_dice"], label="pseudo dice")
            axes[1].plot(x, self.logging["ema_fg_dice"], label="pseudo dice (EMA)")
        axes[1].legend()
        axes[1].set_ylabel("dice")
        axes[2].plot(x, self.logging["lrs"], label="lr")
        axes[2].legend()
        axes[2].set_ylabel("learning rate")
        axes[2].set_xlabel("epoch")
        plt.tight_layout()
        fig.savefig(os.path.join(output_folder, "progress.png"))
        plt.close(fig)
