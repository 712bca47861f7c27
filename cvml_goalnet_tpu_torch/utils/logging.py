"""ANSI console logging of the training loop.

The port's copy of ``cvml_goalnet_tpu/utils/logging.py`` (reference ``class
color`` + print style, ``main.py:14-24,249-293``), kept here because the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import sys


class Color:
    PURPLE = "\033[95m"
    CYAN = "\033[96m"
    BLUE = "\033[94m"
    GREEN = "\033[92m"
    YELLOW = "\033[93m"
    RED = "\033[91m"
    BOLD = "\033[1m"
    END = "\033[0m"


def _tty() -> bool:
    return sys.stdout.isatty()


def _wrap(code: str, s: str) -> str:
    return f"{code}{s}{Color.END}" if _tty() else s


def log_epoch_header(epoch: int, num_epochs: int) -> None:
    print(_wrap(Color.BOLD, f"Epoch {epoch}/{num_epochs - 1}") + "\n")


def log_val_delta(val_loss: float, prev_val_loss: float) -> None:
    """Green ↓ / red ↑ validation-loss delta (reference ``main.py:251-254``)."""
    delta = abs(val_loss - prev_val_loss)
    if val_loss < prev_val_loss:
        print("Val ΔL " + _wrap(Color.GREEN, f"↓ {delta:.4f}"))
    else:
        print("Val ΔL " + _wrap(Color.RED, f"↑ {delta:.4f}"))


def log_metrics(label: str, train: tuple, val: tuple | None, dt: float | None = None) -> None:
    msg = f"[{label}] Train - loss: {train[0]:.4f} - F-avg: {train[1]:.4f} - F-max: {train[2]:.4f}"
    if val is not None:
        msg += f"\n[{label}] Val   - loss: {val[0]:.4f} - F-avg: {val[1]:.4f} - F-max: {val[2]:.4f}"
    else:
        msg += f"\n[{label}] Val   - (no validation videos)"
    if dt is not None:
        msg += f"\nΔt: {dt:.1f}s"
    print(msg)
