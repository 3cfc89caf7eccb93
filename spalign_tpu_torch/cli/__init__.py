"""Command-line entry points of the port
(``python -m spalign_tpu_torch.cli.<tool>``), the tool map of
``spalign_tpu/cli/__init__.py``:

  label_gen      pseudo-label generation (spalign/direct/overlaps;
                 batch_spalign_kmeans.py, direct_clustering.py,
                 superpixel_overlaps.py, utils/apply_spalign_kmeans.py)
  train          SegNet training            (train_segnet.py)
  rounds         multi-round self-training  (utils/run_train_rounds.py)
  relabel        labels from a snapshot     (labels_from_segnet.py)
  mean_result    result.json aggregation    (utils/mean_result.py)
  make_table     cross-round tables/plots   (utils/make_table.py)
  bottom_half    trivial baseline           (utils/check_bottom_half_iou.py)
  demo_video     video overlay              (utils/create_demovideo.py +
                 utils/create_movie.py)
  make_zips      dataset zip packaging      (utils/create_zip_files.sh)
  convert_model  DRN .pth -> the port's .pth (models/convert_pth2ch.py)
  sweep          ablation grids             (utils/dmux/*)

The tools that use the device take ``--device`` (default ``cuda``); the
host-only tools (mean_result, make_table, make_zips), which use none in
the JAX package either, take JAX's flags alone.
"""
