"""Analysis of the flow tree: jacobian, strain, contour tracking, SSIM, strain curves, statistics."""
