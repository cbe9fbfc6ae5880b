// Native MJPEG -> RGB decoder.
//
// Host-side equivalent of the reference's C++ libjpeg decoder
// (decoder/mjpeg-decoder-sw.cpp): MJPEG frames from UVC cameras often omit
// the Huffman tables (relying on the ISO/IEC 10918-1 Annex K.3.3 defaults),
// so the decoder installs the standard tables when the header carries none
// (reference behavior at mjpeg-decoder-sw.cpp:88-93,116-119), decodes to
// RGB with the fast integer DCT (reference :121-122), and recovers from
// corrupt frames via setjmp, reporting failure instead of aborting
// (reference :108-110) so the engine can keep the previous frame.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment), plus a
// batch entry point that decodes N frames on a thread pool -- the host-side
// ingest must keep up with multi-camera rigs feeding one device batch
// (SURVEY.md section 7, hard part 6).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <setjmp.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void error_exit_longjmp(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jb, 1);
}

void emit_message_quiet(j_common_ptr, int) {}

// ISO/IEC 10918-1 Annex K.3.3 default Huffman tables.
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};

const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};

const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

void fill_huff_table(j_decompress_ptr cinfo, JHUFF_TBL** tbl_ptr,
                     const uint8_t* bits, const uint8_t* vals, size_t n_vals) {
  if (*tbl_ptr == nullptr) {
    *tbl_ptr = jpeg_alloc_huff_table(reinterpret_cast<j_common_ptr>(cinfo));
  }
  std::memcpy((*tbl_ptr)->bits, bits, 17);
  std::memcpy((*tbl_ptr)->huffval, vals, n_vals);
}

void install_default_huff_tables(j_decompress_ptr cinfo) {
  fill_huff_table(cinfo, &cinfo->dc_huff_tbl_ptrs[0], kDcLumaBits, kDcVals, 12);
  fill_huff_table(cinfo, &cinfo->ac_huff_tbl_ptrs[0], kAcLumaBits, kAcLumaVals, 162);
  fill_huff_table(cinfo, &cinfo->dc_huff_tbl_ptrs[1], kDcChromaBits, kDcVals, 12);
  fill_huff_table(cinfo, &cinfo->ac_huff_tbl_ptrs[1], kAcChromaBits, kAcChromaVals, 162);
}

bool has_any_huff_table(j_decompress_ptr cinfo) {
  for (int i = 0; i < NUM_HUFF_TBLS; ++i) {
    if (cinfo->dc_huff_tbl_ptrs[i] != nullptr ||
        cinfo->ac_huff_tbl_ptrs[i] != nullptr) {
      return true;
    }
  }
  return false;
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 on corrupt data, -2 on size mismatch.
// out must hold width*height*3 bytes (RGB).
int rtdm_jpeg_decode(const uint8_t* data, unsigned long len, int width,
                     int height, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_longjmp;
  jerr.pub.emit_message = emit_message_quiet;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  if (!has_any_huff_table(&cinfo)) {
    install_default_huff_tables(&cinfo);
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_IFAST;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != width ||
      static_cast<int>(cinfo.output_height) != height ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode n frames concurrently on up to n_threads threads.
// datas/lens: per-frame encoded buffers; out: n contiguous width*height*3
// slots; status: per-frame return codes (as rtdm_jpeg_decode).
void rtdm_jpeg_decode_batch(const uint8_t* const* datas,
                            const unsigned long* lens, int n, int width,
                            int height, uint8_t* out, int* status,
                            int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      status[i] = rtdm_jpeg_decode(
          datas[i], lens[i], width, height,
          out + static_cast<size_t>(i) * width * height * 3);
    }
  };
  int workers = n < n_threads ? n : n_threads;
  std::vector<std::thread> threads;
  threads.reserve(workers - 1);
  for (int t = 1; t < workers; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // extern "C"
