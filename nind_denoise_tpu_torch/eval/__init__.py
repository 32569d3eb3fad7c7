# evaluation: score (file-pair metrics), denoise_dir (test-reserve harness),
# grapher (results plots)
