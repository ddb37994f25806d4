"""K3's levels an epoch (a rotation step's levels are its longest chain
of dependent entries, ``LevelSchedule.n_levels``): the program's counter
``ops/mfsgd_kernel.K3_WORK["levels"]``, which every K3 call adds to.
It counts the whole process's calls, and every epoch runs the same
rotation steps on the same schedules, so an epoch's count is the counter
over the K3 launches the program counted (``LAUNCHES``) times the K3
launches of a traced epoch.  Nothing where the program keeps no such
counter, or K3 did not run."""


def read(rec):
    from harp_tpu_torch.ops import mfsgd_kernel

    work = getattr(mfsgd_kernel, "K3_WORK", None)
    launched = mfsgd_kernel.LAUNCHES["sgd_tile_update"]
    per_epoch = sum(o["tag"] == "K3" for o in rec["trace"]["ops"]) \
        / rec["slice"]["epochs"]
    if work is None or launched == 0 or per_epoch == 0:
        return None
    return work["levels"] / launched * per_epoch
