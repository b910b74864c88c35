from tpuimg_torch.utils.io import imread_gray, imread_rgb, imwrite

__all__ = ["imread_gray", "imread_rgb", "imwrite"]
