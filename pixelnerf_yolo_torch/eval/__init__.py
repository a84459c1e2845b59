"""Evaluation CLIs of the port, one module each, run as
``python -m pixelnerf_yolo_torch.eval.<name>``: eval_yolo,
gen_images_yolo, eval, eval_approx, eval_real, gen_video and
calc_metrics, with the flags of the repo's eval/*.py and ``--device``
(default cuda).  Each keeps its compute in a function that takes the
model, renderer and data and returns what it measured or rendered; main()
parses argv and reads and writes the files.  imageio and cv2 are imported
only where files are read or written."""
