from tpuimg_torch.ops.gaussian import gaussian
from tpuimg_torch.ops.guided import box_filter, guided_filter
from tpuimg_torch.ops.histogram import clahe, hist_equalize
from tpuimg_torch.ops.integral import integral

__all__ = ["box_filter", "clahe", "gaussian", "guided_filter", "hist_equalize",
           "integral"]
