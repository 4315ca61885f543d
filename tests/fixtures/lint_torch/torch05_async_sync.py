"""Planted TORCH05 fixture: event-loop-blocking syncs in async defs."""
import asyncio

import numpy as np
import torch


async def respond(scores):
    total = scores.sum().item()
    host = scores.cpu()
    torch.cuda.synchronize()
    arr = np.asarray(scores)
    return total, host, arr


async def respond_host(meta):
    await asyncio.sleep(0)
    return np.asarray(meta)  # noqa: TORCH05 - host-side metadata


def sync_compute(scores):
    # not async: the same calls are fine on an executor thread
    torch.cuda.synchronize()
    return scores.cpu().numpy()
