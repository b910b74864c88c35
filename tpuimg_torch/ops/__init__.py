from tpuimg_torch.ops.gaussian import gaussian
from tpuimg_torch.ops.guided import box_filter, guided_filter
from tpuimg_torch.ops.histogram import clahe

__all__ = ["box_filter", "clahe", "gaussian", "guided_filter"]
