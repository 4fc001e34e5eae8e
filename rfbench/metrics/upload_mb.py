"""Megabytes (10^6 bytes) a render that ``RenderingPipeline`` moved from
host memory to its device, over the whole run (set-up's renders, the
window's and the tail's): its ``UPLOADS`` counter, bytes over calls.  None
for a program without the counter, or one that moved nothing (a pipeline
on the host)."""


def read(run):
    from renderformer_tpu_torch.pipelines import rendering_pipeline
    uploads = getattr(rendering_pipeline, 'UPLOADS', None)
    if not uploads or not uploads['renders'] or not uploads['bytes']:
        return None
    return uploads['bytes'] * 1e-6 / uploads['renders']
